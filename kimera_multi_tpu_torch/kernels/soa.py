"""Structure-of-arrays minimal-solver math.

The hypothesis-solving stage of batched RANSAC runs hundreds of thousands
of tiny (3x3 / 9x9) problems per verification chunk. Here every
matrix/vector entry is its own tensor over the hypothesis axes, so all
arithmetic is dense elementwise work over (candidates, hypotheses) and no
(B, 9, 9) tensor is ever formed.

Semantics mirror kernels/linalg.py + kernels/minimal.py line by line (same
shifts, same degeneracy fallbacks, same epsilons), and the same-named
functions of the JAX package's kernels/soa.py.

Representation: a 3-vector is a list [x, y, z] of tensors; a 3x3 matrix is
a row-major nested list; a 9-vector is a flat list. Shapes are whatever
broadcasts — callers pass (C, H).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


# ---------------------------------------------------------------------------
# vector helpers (vec3 = [x, y, z] of (B,) tensors)
# ---------------------------------------------------------------------------


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def v_cross(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def v_scale(a, s):
    return [a[0] * s, a[1] * s, a[2] * s]


def v_sub(a, b):
    return [a[0] - b[0], a[1] - b[1], a[2] - b[2]]


def v_add(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def v_norm(a):
    return torch.sqrt(v_dot(a, a))


def _safe_unit(v):
    """Mirror of linalg._safe_unit: unit(v), or e0 when ||v|| <= 1e-9."""
    n = v_norm(v)
    inv = 1.0 / torch.clamp(n, min=_EPS)
    good = n > 1e-9
    one = torch.ones_like(v[0])
    zero = torch.zeros_like(v[0])
    return [
        torch.where(good, v[0] * inv, one),
        torch.where(good, v[1] * inv, zero),
        torch.where(good, v[2] * inv, zero),
    ]


def _unit(v):
    """Mirror of minimal._unit: v / max(||v||, eps)."""
    inv = 1.0 / torch.clamp(v_norm(v), min=_EPS)
    return v_scale(v, inv)


def _any_orthogonal(u):
    """Mirror of linalg._any_orthogonal: unit vector orthogonal to unit u,
    branchless."""
    ax, ay, az = torch.abs(u[0]), torch.abs(u[1]), torch.abs(u[2])
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    one = torch.ones_like(u[0])
    zero = torch.zeros_like(u[0])
    e = [
        torch.where(use_x, one, zero),
        torch.where(use_y, one, zero),
        torch.where(~(use_x | use_y), one, zero),
    ]
    return _safe_unit(v_cross(u, e))


def mat3_vec(M, v):
    """(M v) for row-major nested-list M."""
    return [v_dot(M[i], v) for i in range(3)]


def mat3T_vec(M, v):
    return [M[0][i] * v[0] + M[1][i] * v[1] + M[2][i] * v[2]
            for i in range(3)]


def stack_mat3(M):
    """Nested-list mat3 -> (..., 3, 3) tensor (one relayout at the
    SoA/AoS boundary)."""
    return torch.stack(
        [torch.stack(M[i], dim=-1) for i in range(3)], dim=-2)


def stack_vec(v):
    return torch.stack(v, dim=-1)


def unstack_mat3(A):
    """(..., 3, 3) -> nested list."""
    return [[A[..., i, j] for j in range(3)] for i in range(3)]


def unstack_vec(a):
    return [a[..., i] for i in range(a.shape[-1])]


# ---------------------------------------------------------------------------
# analytic symmetric 3x3 eigendecomposition (mirror of linalg.eigh3x3)
# ---------------------------------------------------------------------------


def eigh3x3(A):
    """A: symmetric mat3 (nested list). Returns (evals [e1, e2, e3]
    DESCENDING, eigvecs [v1, v2, v3] column vec3s)."""
    a00, a01, a02 = A[0][0], A[0][1], A[0][2]
    a11, a12, a22 = A[1][1], A[1][2], A[2][2]

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

    v1 = _eigvec(A, e1)
    v3_raw = _eigvec(A, e3)
    v3 = v_sub(v3_raw, v_scale(v1, v_dot(v3_raw, v1)))
    n3 = v_norm(v3)
    v3_fb = _any_orthogonal(v1)
    inv3 = 1.0 / torch.clamp(n3, min=_EPS)
    good = n3 > 1e-6
    v3 = [torch.where(good, v3[i] * inv3, v3_fb[i]) for i in range(3)]
    v2 = v_cross(v3, v1)
    return [e1, e2, e3], [v1, v2, v3]


def _eigvec(A, lam):
    """Mirror of linalg._eigvec: largest row-cross-product of (A - lam I),
    with rank-deficiency fallback."""
    r0 = [A[0][0] - lam, A[0][1], A[0][2]]
    r1 = [A[0][1], A[1][1] - lam, A[1][2]]  # symmetric: A[1][0] == A[0][1]
    r2 = [A[0][2], A[1][2], A[2][2] - lam]
    c01 = v_cross(r0, r1)
    c02 = v_cross(r0, r2)
    c12 = v_cross(r1, r2)
    n01 = v_dot(c01, c01)
    n02 = v_dot(c02, c02)
    n12 = v_dot(c12, c12)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    v = [
        torch.where(use01, c01[i], torch.where(use02, c02[i], c12[i]))
        for i in range(3)
    ]
    n = v_norm(v)
    l0, l1, l2 = v_dot(r0, r0), v_dot(r1, r1), v_dot(r2, r2)
    r01 = (l0 >= l1) & (l0 >= l2)
    r02 = (~r01) & (l1 >= l2)
    big_row = [
        torch.where(r01, r0[i], torch.where(r02, r1[i], r2[i]))
        for i in range(3)
    ]
    fb = _any_orthogonal(_safe_unit(big_row))
    inv = 1.0 / torch.clamp(n, min=_EPS)
    good = n > 1e-9
    return [torch.where(good, v[i] * inv, fb[i]) for i in range(3)]


# ---------------------------------------------------------------------------
# SO(3) Procrustes + Arun 3-point (mirror of linalg.so3_procrustes /
# minimal.arun_3d3d on minimal samples)
# ---------------------------------------------------------------------------


def so3_procrustes(H):
    """R* = argmax tr(R H); H nested-list mat3. Returns (R mat3, ok)."""
    # A = H^T H
    A = [[sum(H[l][i] * H[l][j] for l in range(3)) for j in range(3)]
         for i in range(3)]
    evals, V = eigh3x3(A)
    s1 = torch.sqrt(torch.clamp(evals[0], min=0.0))
    s2 = torch.sqrt(torch.clamp(evals[1], min=0.0))
    v1, v2 = V[0], V[1]
    u1 = _safe_unit(mat3_vec(H, v1))
    u2_raw = mat3_vec(H, v2)
    u2 = _safe_unit(v_sub(u2_raw, v_scale(u1, v_dot(u2_raw, u1))))
    u3 = v_cross(u1, u2)
    v3 = v_cross(v1, v2)
    # R = Vp U^T with Vp columns (v1, v2, v3), U columns (u1, u2, u3):
    # R[i][j] = sum_k (v_k)_i (u_k)_j
    vs, us = [v1, v2, v3], [u1, u2, u3]
    R = [[sum(vs[k][i] * us[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    ok = s2 > 1e-7 * torch.clamp(s1, min=1.0)
    return R, ok


def arun3(ps, qs):
    """Minimal (3-point) rigid alignment. ps, qs: lists of 3 vec3s (each
    component a (B,) tensor). Returns (R mat3, t vec3, ok (B,)).

    Mirrors minimal.arun_3d3d with uniform weights w = 1/3.
    """
    third = 1.0 / 3.0
    pbar = v_scale(v_add(v_add(ps[0], ps[1]), ps[2]), third)
    qbar = v_scale(v_add(v_add(qs[0], qs[1]), qs[2]), third)
    pc = [v_sub(ps[k], pbar) for k in range(3)]
    qc = [v_sub(qs[k], qbar) for k in range(3)]
    # H[i][j] = sum_k (1/3) pc_k[i] qc_k[j]
    H = [[third * sum(pc[k][i] * qc[k][j] for k in range(3))
          for j in range(3)] for i in range(3)]
    R, ok = so3_procrustes(H)
    t = v_sub(qbar, mat3_vec(R, pbar))
    return R, t, ok


# ---------------------------------------------------------------------------
# 9x9 SPD: unrolled Cholesky + inverse iteration (mirror of
# linalg.cholesky_unrolled / _tri_solve_unrolled / smallest_eigvec_psd)
# ---------------------------------------------------------------------------


def chol_soa(A):
    """A: nested list (n x n, symmetric SPD entries as (B,) tensors).
    Returns L as nested list (lower triangle populated)."""
    n = len(A)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        dj = torch.sqrt(torch.clamp(s, min=_EPS))
        L[j][j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_dj
    return L


def tri_solve_soa(L, b, lower: bool):
    """Solve L x = b (lower) or L^T x = b; b a flat list of (B,) tensors."""
    n = len(L)
    x = [None] * n
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        s = b[i]
        if lower:
            for k in range(i):
                s = s - L[i][k] * x[k]
        else:
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def smallest_eigvec_soa(N, iters: int = 4, shift_scale: float = 1e-7):
    """Bottom eigenvector of symmetric PSD N (nested list of (B,) entries)
    via shifted inverse iteration. Mirrors linalg.smallest_eigvec_psd."""
    n = len(N)
    tr = sum(N[i][i] for i in range(n))
    shift = shift_scale * tr / n + 1e-12
    A = [list(row) for row in N]
    for i in range(n):
        A[i][i] = N[i][i] + shift
    L = chol_soa(A)
    # deterministic init: one-hot at the smallest diagonal entry (first
    # minimal index on ties, matching argmin), plus 0.1
    d = [N[i][i] for i in range(n)]
    best_val, best_idx = d[0], torch.zeros_like(d[0], dtype=torch.int32)
    for a in range(1, n):
        better = d[a] < best_val
        best_val = torch.where(better, d[a], best_val)
        best_idx = torch.where(better, a, best_idx)
    v = [(best_idx == a).to(d[0].dtype) + 0.1 for a in range(n)]
    nv = torch.sqrt(sum(c * c for c in v))
    v = [c / nv for c in v]
    for _ in range(iters):
        y = tri_solve_soa(L, v, lower=True)
        v = tri_solve_soa(L, y, lower=False)
        nv = torch.clamp(torch.sqrt(sum(c * c for c in v)), min=_EPS)
        v = [c / nv for c in v]
    return v


# ---------------------------------------------------------------------------
# essential matrix from 8 minimal correspondences (mirror of
# minimal.essential_8pt on the minimal-sample path, uniform weights)
# ---------------------------------------------------------------------------


def essential8(f1s, f2s):
    """f1s, f2s: lists of 8 vec3 bearing vectors (components (B,) tensors).
    Returns (E mat3, ok (B,)) — least-squares essential matrix projected to
    the (s, s, 0) manifold. Row convention matches minimal.essential_8pt:
    row = outer(f2, f1).ravel(), i.e. r[3 i + j] = f2_i * f1_j.
    """
    k = len(f1s)
    rows = []
    for m in range(k):
        f1, f2 = f1s[m], f2s[m]
        rows.append([f2[i] * f1[j] for i in range(3) for j in range(3)])
    # N = sum_m outer(row_m, row_m)  (9x9 symmetric)
    N = [[None] * 9 for _ in range(9)]
    for a in range(9):
        for b in range(a, 9):
            s = rows[0][a] * rows[0][b]
            for m in range(1, k):
                s = s + rows[m][a] * rows[m][b]
            N[a][b] = s
            N[b][a] = s
    return project_essential_soa(smallest_eigvec_soa(N))


def project_essential_soa(E):
    """Project a row-major 9-entry SoA matrix onto the essential manifold:
    E <- u1 v1^T + u2 v2^T where (v1, v2) are the top-2 eigenvectors of
    E^T E. Returns (Eproj nested 3x3 list, ok)."""
    Em = [[E[3 * i + j] for j in range(3)] for i in range(3)]
    A = [[sum(Em[l][i] * Em[l][j] for l in range(3)) for j in range(3)]
         for i in range(3)]
    evals, V = eigh3x3(A)
    s1 = torch.sqrt(torch.clamp(evals[0], min=0.0))
    s2 = torch.sqrt(torch.clamp(evals[1], min=0.0))
    v1, v2 = V[0], V[1]
    u1 = _unit(mat3_vec(Em, v1))
    u2r = mat3_vec(Em, v2)
    u2 = _unit(v_sub(u2r, v_scale(u1, v_dot(u2r, u1))))
    Eproj = [[u1[i] * v1[j] + u2[i] * v2[j] for j in range(3)]
             for i in range(3)]
    ok = s2 > 1e-6 * torch.clamp(s1, min=_EPS)
    return Eproj, ok


# ---------------------------------------------------------------------------
# 5-point essential polish: Gauss-Newton on S^3 intersecting the essential
# variety (mirror of soa.essential5_polish_soa of the JAX package)
# ---------------------------------------------------------------------------


def _sum(terms):
    """Left-to-right sum, first term first (no leading `0 +`): the order in
    which csrc/fivept.cu adds, so that kernel and plain version round
    alike."""
    it = iter(terms)
    s = next(it)
    for t in it:
        s = s + t
    return s


def _gn_step(B9, qc, step_cap, damping):
    """One Gauss-Newton step of `essential5_polish_soa`. Every operation is
    one elementwise tensor op, in the order csrc/fivept.cu repeats."""
    E = [_sum(qc[s] * B9[s][i] for s in range(4)) for i in range(9)]

    def at(M, r, c):
        return M[3 * r + c]

    # E E^T and E^T E (symmetric 3x3, as nested lists)
    EEt = [[_sum(at(E, r, k) * at(E, c, k) for k in range(3))
            for c in range(3)] for r in range(3)]
    EtE = [[_sum(at(E, k, r) * at(E, k, c) for k in range(3))
            for c in range(3)] for r in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]

    # residual r = [det(E), vec(2 EEt E - tr E)]
    det = (at(E, 0, 0) * (at(E, 1, 1) * at(E, 2, 2)
                          - at(E, 1, 2) * at(E, 2, 1))
           - at(E, 0, 1) * (at(E, 1, 0) * at(E, 2, 2)
                            - at(E, 1, 2) * at(E, 2, 0))
           + at(E, 0, 2) * (at(E, 1, 0) * at(E, 2, 1)
                            - at(E, 1, 1) * at(E, 2, 0)))
    res = [det] + [2.0 * _sum(EEt[r][k] * at(E, k, c) for k in range(3))
                   - tr * at(E, r, c) for r in range(3) for c in range(3)]

    # cofactor matrix (d det / d E_rc)
    cof = [[at(E, (r + 1) % 3, (c + 1) % 3) * at(E, (r + 2) % 3, (c + 2) % 3)
            - at(E, (r + 1) % 3, (c + 2) % 3) * at(E, (r + 2) % 3, (c + 1) % 3)
            for c in range(3)] for r in range(3)]

    # analytic Jacobian columns (10 x 4)
    J = []
    for s in range(4):
        V = B9[s]
        d_det = _sum(cof[r][c] * at(V, r, c)
                     for r in range(3) for c in range(3))
        trEV = _sum(E[i] * V[i] for i in range(9))
        VtE = [[_sum(at(V, k, r) * at(E, k, c) for k in range(3))
                for c in range(3)] for r in range(3)]
        col = [d_det]
        for r in range(3):
            for c in range(3):
                m_a = _sum(at(V, r, k) * EtE[k][c] for k in range(3))
                m_b = _sum(at(E, r, k) * VtE[k][c] for k in range(3))
                m_c = _sum(EEt[r][k] * at(V, k, c) for k in range(3))
                col.append(2.0 * (m_a + m_b + m_c)
                           - 2.0 * trEV * at(E, r, c) - tr * at(V, r, c))
        J.append(col)

    # project the radial gauge direction out of J: J_k -= <J_k, q> q
    for k in range(10):
        dk = _sum(J[s][k] * qc[s] for s in range(4))
        for s in range(4):
            J[s][k] = J[s][k] - dk * qc[s]

    # normal equations (4x4) + damping
    JtJ = [[_sum(J[i][k] * J[j][k] for k in range(10)) for j in range(4)]
           for i in range(4)]
    for i in range(4):
        JtJ[i][i] = JtJ[i][i] + damping
    g = [_sum(J[i][k] * res[k] for k in range(10)) for i in range(4)]

    L = chol_soa(JtJ)
    y = tri_solve_soa(L, [-gi for gi in g], lower=True)
    dq = tri_solve_soa(L, y, lower=False)
    # project the gauge out of the step, cap, renormalize
    dq_q = _sum(dq[s] * qc[s] for s in range(4))
    dq = [dq[s] - dq_q * qc[s] for s in range(4)]
    n = torch.sqrt(_sum(d * d for d in dq))
    # step_cap / x is x.reciprocal() * step_cap in torch; the kernel
    # computes the same two roundings
    scale = torch.clamp(step_cap / torch.clamp(n, min=_EPS), max=1.0)
    qn = [qc[s] + dq[s] * scale for s in range(4)]
    nq = torch.clamp(torch.sqrt(_sum(c * c for c in qn)), min=_EPS)
    return [c / nq for c in qn]


def essential5_polish_soa(B9, q, n_iters: int = 16, step_cap: float = 0.4,
                          damping: float = 1e-6):
    """Multi-root GN polish for the 5-point problem, lane-major.

    E(q) = sum_s q_s B_s must satisfy the 10 essential constraints
    (det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0). B9: list over s=0..3 of
    9-entry row-major lists of tensors; q: list of 4 tensors broadcastable
    against them (callers put the multi-start axis in q only). The
    Jacobian is analytic (d det = <cof(E), V>; dC[V] = 2(V E^T E + E V^T E
    + E E^T V) - 2 tr(E V^T) E - tr(E E^T) V). The constraint system is
    homogeneous, so the radial direction is projected out of J and the
    step; steps are capped at `step_cap` and q is renormalized.
    """
    q = list(q)
    for _ in range(n_iters):
        q = _gn_step(B9, q, step_cap, damping)
    return q
