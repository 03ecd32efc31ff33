"""Analytic batched small-matrix linear algebra.

RANSAC refits need tiny (3x3, 9x9) eigen problems per candidate. These
closed-form versions are elementwise tensor math, batched over any leading
axes and branchless: the same shifts, epsilons and degeneracy fallbacks as
the JAX package's kernels/linalg.py, so both give the same eigenvector
signs and order (which `torch.linalg.eigh` would not). Products of
3 x 3 blocks and sums over many points are written in a fixed order
(`core/lie.py::mat3_mul`, `tree_sum`), so a candidate's result does not
depend on how many candidates share the call.
"""

from __future__ import annotations

import math

import torch

from ..core.lie import mat3_mul, mat3_vec

_EPS = 1e-12


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, added pairwise along a fixed tree (zero
    padded to a power of two): elementwise adds only, so the result is the
    same bits whatever the leading shape and on every device (a library
    reduction picks its order from the shape and the device)."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(tree_sum(v * v)[..., None])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _basis(like: torch.Tensor, i: int) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def eigh3x3(A: torch.Tensor):
    """Analytic eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (eigvals (..., 3) DESCENDING, eigvecs (..., 3, 3) columns).
    Trigonometric method for the values; eigenvectors via the largest
    cross-product of rows of (A - lambda I), with degeneracy fallbacks
    selected branchlessly.
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    evals = torch.stack([e1, e2, e3], dim=-1)

    v1 = _eigvec(A, e1)
    v3_raw = _eigvec(A, e3)
    # orthogonalize v3 against v1 (rescues near-degenerate cases)
    v3 = v3_raw - tree_sum(v3_raw * v1)[..., None] * v1
    n3 = _norm(v3)
    v3_fb = _any_orthogonal(v1)
    v3 = torch.where(n3 > 1e-6, v3 / torch.clamp(n3, min=_EPS), v3_fb)
    v2 = _cross(v3, v1)
    V = torch.stack([v1, v2, v3], dim=-1)  # columns
    return evals, V


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric 3x3 for eigenvalue lam: the largest cross
    product of two rows of (A - lam I), with a rank-deficiency fallback."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = tree_sum(c01 * c01)[..., None]
    n02 = tree_sum(c02 * c02)[..., None]
    n12 = tree_sum(c12 * c12)[..., None]
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    v = torch.where(use01, c01, torch.where(use02, c02, c12))
    n = _norm(v)
    l0 = tree_sum(r0 * r0)[..., None]
    l1 = tree_sum(r1 * r1)[..., None]
    l2 = tree_sum(r2 * r2)[..., None]
    r01 = (l0 >= l1) & (l0 >= l2)
    r02 = (~r01) & (l1 >= l2)
    big_row = torch.where(r01, r0, torch.where(r02, r1, r2))
    fb = _any_orthogonal(_safe_unit(big_row))
    return torch.where(n > 1e-9, v / torch.clamp(n, min=_EPS), fb)


def _safe_unit(v: torch.Tensor) -> torch.Tensor:
    n = _norm(v)
    return torch.where(n > 1e-9, v / torch.clamp(n, min=_EPS), _basis(v, 0))


def _any_orthogonal(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit vector u, branchless."""
    ax = torch.abs(u[..., 0:1])
    ay = torch.abs(u[..., 1:2])
    az = torch.abs(u[..., 2:3])
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    e = torch.where(use_x, _basis(u, 0),
                    torch.where(use_y, _basis(u, 1), _basis(u, 2)))
    return _safe_unit(_cross(u, e))


def so3_procrustes(H: torch.Tensor):
    """R* = argmax_{R in SO(3)} tr(R H) for (..., 3, 3) H — the rotation
    step of Arun's 3d-3d alignment, closed form via eigh(H^T H); a rank-2 H
    is completed with cross products, which also enforces det(R) = +1.

    Returns (R, ok) where ok is False when rank(H) < 2 (collinear points).
    """
    A = mat3_mul(H.transpose(-1, -2), H)
    evals, V = eigh3x3(A)
    s = torch.sqrt(torch.clamp(evals, min=0.0))  # singular values, descending
    v1, v2 = V[..., :, 0], V[..., :, 1]
    u1 = _safe_unit(mat3_vec(H, v1))
    u2_raw = mat3_vec(H, v2)
    u2 = _safe_unit(u2_raw - tree_sum(u2_raw * u1)[..., None] * u1)
    u3 = _cross(u1, u2)
    v3 = _cross(v1, v2)
    U = torch.stack([u1, u2, u3], dim=-1)
    Vp = torch.stack([v1, v2, v3], dim=-1)
    R = mat3_mul(Vp, U.transpose(-1, -2))
    ok = s[..., 1] > 1e-7 * torch.clamp(s[..., 0], min=1.0)
    return R, ok


def cholesky_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky for small static n via unrolled scalar recurrences.
    A: (..., n, n) SPD. Returns the lower factor."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        dj = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_dj
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def _tri_solve_unrolled(L: torch.Tensor, b: torch.Tensor, lower: bool):
    """Solve L x = b (lower) or L^T x = b, unrolled for small static n.
    b: (..., n)."""
    n = L.shape[-1]
    x = [None] * n
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        s = b[..., i]
        if lower:
            for k in range(i):
                s = s - L[..., i, k] * x[k]
        else:
            for k in range(i + 1, n):
                s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_psd(N: torch.Tensor, iters: int = 4,
                        shift_scale: float = 1e-7) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of a batched PSD matrix (..., n, n)
    via shifted inverse iteration with an unrolled Cholesky. Inverse
    iteration amplifies the bottom eigenvector by (lam2+shift)/(lam1+shift)
    per step, so a handful of solves suffice for RANSAC normal matrices
    whose smallest eigenvalue is ~0."""
    n = N.shape[-1]
    d = torch.diagonal(N, dim1=-2, dim2=-1)
    tr = tree_sum(d)
    shift = (shift_scale * tr / n + 1e-12)[..., None, None]
    A = N + shift * torch.eye(n, dtype=N.dtype, device=N.device)
    L = cholesky_unrolled(A)
    # deterministic init biased toward the smallest diagonal entry (the
    # first such entry on ties)
    ar = torch.arange(n, device=N.device)
    is_min = d == torch.min(d, dim=-1, keepdim=True).values
    k = torch.min(torch.where(is_min, ar, n), dim=-1, keepdim=True).values
    v = (ar == k).to(N.dtype) + 0.1
    v = v / _norm(v)
    for _ in range(iters):
        y = _tri_solve_unrolled(L, v, lower=True)
        v = _tri_solve_unrolled(L, y, lower=False)
        v = v / torch.clamp(_norm(v), min=_EPS)
    return v


def polar_orthonormalize(M: torch.Tensor) -> torch.Tensor:
    """Closest orthonormal-column matrix to (..., r, 3): the polar factor
    M (M^T M)^(-1/2) through the closed-form 3x3 eigendecomposition, the
    eigenvalues clamped at 1e-12 (needs full column rank, which retraction
    inputs Y + small steps have)."""
    A = M.transpose(-1, -2) @ M
    evals, V = eigh3x3(A)
    s = 1.0 / torch.sqrt(torch.clamp(evals, min=1e-12))
    inv_sqrt = (V * s[..., None, :]) @ V.transpose(-1, -2)
    return M @ inv_sqrt
