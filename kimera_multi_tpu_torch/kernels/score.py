"""Fused RANSAC hypothesis scoring.

Scoring is the heavy half of batched RANSAC: a naive formulation
materializes (C, H, K) residual tensors (gigabytes per verification
chunk). The CUDA kernels (csrc/score.cu) compute inlier COUNTS per
hypothesis with the residuals in registers; the (C, H) counts are the
only writes. The winning hypothesis's inlier MASK is recomputed
afterwards for the single best model.

Both kernels have a plain PyTorch version (`*_ref`) taken for CPU tensors.
It is written as elementwise operations in a fixed order, and the kernels
repeat that order without FMA contraction, so the counts of the two paths
agree exactly.
"""

from __future__ import annotations

import torch

from . import _build

_EPS = 1e-12


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis, as `jnp.argmax`
    gives it. Inlier counts are integers and tie often; `torch.argmax`
    promises no particular index among equal maxima on the card."""
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device)
    mx = torch.max(x, dim=-1, keepdim=True).values
    return torch.min(torch.where(x == mx, ar, n), dim=-1).values


def _mat_rows(M, x):
    """Rows of M x for M (C, H, 3, 3) and x (C, 3, K), each (C, H, K),
    summed left to right."""
    xs = [x[:, None, i, :] for i in range(3)]
    return [
        (M[..., i, 0, None] * xs[0] + M[..., i, 1, None] * xs[1])
        + M[..., i, 2, None] * xs[2]
        for i in range(3)
    ]


def rigid_counts_ref(R, t, p, q, valid, threshold):
    """Plain version of `rigid_counts`."""
    thr2 = float(threshold) * float(threshold)
    Rp = _mat_rows(R, p)
    r = [q[:, None, i, :] - (Rp[i] + t[..., i, None]) for i in range(3)]
    d2 = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]
    return torch.sum((d2 < thr2) & valid[:, None, :], dim=-1).to(torch.int32)


def rigid_counts(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor,
                 q: torch.Tensor, valid: torch.Tensor,
                 threshold: float) -> torch.Tensor:
    """Inlier counts for rigid-transform hypotheses:
    #{k valid : ||q_k - (R_h p_k + t_h)||^2 < threshold^2}.

    R: (C, H, 3, 3); t: (C, H, 3); p, q: (C, 3, K) SoA; valid: (C, K) bool.
    Returns (C, H) int32.
    """
    if R.device.type == "cpu":
        return rigid_counts_ref(R, t, p, q, valid, threshold)
    C, H = R.shape[:2]
    K = p.shape[2]
    _build.check_cuda("R", R, torch.float32, (C, H, 3, 3))
    _build.check_cuda("t", t, torch.float32, (C, H, 3))
    _build.check_cuda("p", p, torch.float32, (C, 3, K))
    _build.check_cuda("q", q, torch.float32, (C, 3, K))
    _build.check_cuda("valid", valid, torch.bool, (C, K))
    if C > 65535:
        raise ValueError("rigid_counts: C at most 65535")
    out = torch.empty((C, H), dtype=torch.int32, device=R.device)
    thr2 = float(threshold) * float(threshold)
    with torch.cuda.device(R.device):
        _build.launch("rigid_counts", R.data_ptr(), t.data_ptr(),
                      p.data_ptr(), q.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), C, H, K, thr2)
    return out


def essential_counts_ref(E, f1, f2, valid, threshold):
    """Plain version of `essential_counts`."""
    thr = float(threshold)
    Ef1 = _mat_rows(E, f1)
    Etf2 = _mat_rows(E.transpose(-1, -2), f2)
    b = [f2[:, None, i, :] for i in range(3)]
    num = (b[0] * Ef1[0] + b[1] * Ef1[1]) + b[2] * Ef1[2]
    den = ((Ef1[0] * Ef1[0] + Ef1[1] * Ef1[1]) + Etf2[0] * Etf2[0]) \
        + Etf2[1] * Etf2[1]
    err = (num * num) / torch.clamp(den, min=_EPS)
    return torch.sum((err < thr) & valid[:, None, :], dim=-1).to(torch.int32)


def essential_counts(E: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                     valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Sampson-inlier counts for essential-matrix hypotheses: squared
    Sampson error num^2 / max(den, 1e-12) with num = f2^T E f1 and
    den = (E f1)_x^2 + (E f1)_y^2 + (E^T f2)_x^2 + (E^T f2)_y^2, counted
    where < threshold over the valid correspondences.

    E: (C, H, 3, 3); f1, f2: (C, 3, K) SoA unit bearings; valid: (C, K)
    bool. Returns (C, H) int32.
    """
    if E.device.type == "cpu":
        return essential_counts_ref(E, f1, f2, valid, threshold)
    C, H = E.shape[:2]
    K = f1.shape[2]
    _build.check_cuda("E", E, torch.float32, (C, H, 3, 3))
    _build.check_cuda("f1", f1, torch.float32, (C, 3, K))
    _build.check_cuda("f2", f2, torch.float32, (C, 3, K))
    _build.check_cuda("valid", valid, torch.bool, (C, K))
    if C > 65535:
        raise ValueError("essential_counts: C at most 65535")
    out = torch.empty((C, H), dtype=torch.int32, device=E.device)
    with torch.cuda.device(E.device):
        _build.launch("essential_counts", E.data_ptr(), f1.data_ptr(),
                      f2.data_ptr(), valid.data_ptr(), out.data_ptr(),
                      C, H, K, float(threshold))
    return out
