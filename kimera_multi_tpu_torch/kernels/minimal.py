"""Batched minimal solvers for geometric verification: the consensus
refits (weighted Arun alignment, weighted 8-point essential) and the
Sampson error, on coordinate-major (SoA) point sets with a leading
candidate axis. Counterparts of the same-named functions of the JAX
package's kernels/minimal.py, which are called there under `vmap`.
Sums over the K points and 3 x 3 products go in a fixed order
(`linalg.tree_sum`, `lie.mat3_mul`): a candidate verified alone gets
the same bits as in a batch of any size.
"""

from __future__ import annotations

import torch

from ..core.lie import mat3_mul, mat3_vec
from .linalg import eigh3x3, smallest_eigvec_psd, so3_procrustes, tree_sum

_EPS = 1e-12


def _unit(v):
    n = torch.sqrt(tree_sum(v * v)[..., None])
    return v / torch.clamp(n, min=_EPS)


def _project_essential(E: torch.Tensor):
    """Project (..., 3, 3) onto the essential manifold (two equal singular
    values, one zero) using the analytic primitives."""
    A = mat3_mul(E.transpose(-1, -2), E)
    s2, V = eigh3x3(A)
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    v1, v2 = V[..., :, 0], V[..., :, 1]
    u1 = _unit(mat3_vec(E, v1))
    u2r = mat3_vec(E, v2)
    u2 = _unit(u2r - tree_sum(u2r * u1)[..., None] * u1)
    Ep = (u1[..., :, None] * v1[..., None, :]
          + u2[..., :, None] * v2[..., None, :])
    ok = s[..., 1] > 1e-6 * torch.clamp(s[..., 0], min=_EPS)
    return Ep, ok


def arun_3d3d_soa(p3: torch.Tensor, q3: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment on coordinate-major point sets: (R, t)
    minimizing sum w ||q - (R p + t)||^2.

    p3, q3: (..., 3, K); w: (..., K) nonneg weights.
    Returns (R (..., 3, 3), t (..., 3), ok (...,))."""
    wsum = torch.clamp(tree_sum(w)[..., None], min=_EPS)
    wn = w / wsum
    pbar = tree_sum(p3 * wn[..., None, :])
    qbar = tree_sum(q3 * wn[..., None, :])
    pc = p3 - pbar[..., :, None]
    qc = q3 - qbar[..., :, None]
    H = tree_sum((wn[..., None, None, :] * pc[..., :, None, :])
                 * qc[..., None, :, :])
    R, ok = so3_procrustes(H)
    t = qbar - mat3_vec(R, pbar)
    return R, t, ok


def essential_8pt_soa(f1: torch.Tensor, f2: torch.Tensor,
                      w: torch.Tensor | None = None):
    """Weighted 8-point least-squares essential refit on SoA bearings.

    f1, f2: (..., 3, K); w: (..., K). The design rows are
    row_k = outer(f2_k, f1_k).ravel(), formed as a (9, K) stack;
    N = rows W rows^T is a 9x9 normal matrix whose bottom eigenvector is
    projected to the essential manifold. Returns (E (..., 3, 3), ok)."""
    K = f1.shape[-1]
    if w is None:
        w = torch.ones(f1.shape[:-2] + (K,), dtype=f1.dtype, device=f1.device)
    rows = (f2[..., :, None, :] * f1[..., None, :, :]).reshape(
        *f1.shape[:-2], 9, K)
    N = tree_sum((rows * w[..., None, :])[..., :, None, :]
                 * rows[..., None, :, :])
    e = smallest_eigvec_psd(N)
    E = e.reshape(*e.shape[:-1], 3, 3)
    return _project_essential(E)


def sampson_error_soa(E: torch.Tensor, f1: torch.Tensor,
                      f2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson error on SoA bearings: E (..., 3, 3);
    f1, f2: (..., 3, K). Returns (..., K)."""
    Ef1 = mat3_mul(E, f1)  # (..., 3, K)
    Etf2 = mat3_mul(E.transpose(-1, -2), f2)
    num = (f2[..., 0, :] * Ef1[..., 0, :]
           + f2[..., 1, :] * Ef1[..., 1, :]) + f2[..., 2, :] * Ef1[..., 2, :]
    den = (Ef1[..., 0, :] ** 2 + Ef1[..., 1, :] ** 2
           + Etf2[..., 0, :] ** 2 + Etf2[..., 1, :] ** 2)
    return (num * num) / torch.clamp(den, min=_EPS)
