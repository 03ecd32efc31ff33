"""Minimal-sample gathers.

RANSAC consumes its correspondence data through small random gathers:
(n_hyp, k) sampled indices into a (3, K) point array, with or without the
valid-first permutation of the correspondences folded in, and the
reordering of target points by match index. Output layout of the sample
gather is (k * D, H) with the hypothesis axis minor, so the SoA solvers
(kernels/soa.py) slice whole rows.

Each function takes a leading candidate axis and has two paths with
identical results: an indexed-load CUDA kernel (csrc/gather.cu) for
tensors on the card, advanced indexing for CPU tensors. Indices outside
the valid range are outside the contract; both paths clamp them, so that a
kernel never reads outside its candidate's block.
"""

from __future__ import annotations

import torch

from . import _build


def sample_gather_t_ref(data, picks):
    """Plain version: out[c, m*D + i, h] = data[c, i, picks[c, h, m]]."""
    C, D, K = data.shape
    H, k = picks.shape[1:]
    j = picks.long().reshape(C, H * k).clamp(0, K - 1)
    g = torch.gather(data, 2, j[:, None, :].expand(C, D, H * k))
    return g.reshape(C, D, H, k).permute(0, 3, 1, 2).reshape(C, k * D, H)


def sample_gather_t(data: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """Minimal-sample gather, hypothesis-minor.

    data: (C, D, K) f32 SoA; picks: (C, H, k) int32 in [0, K).
    Returns (C, k * D, H): out[c, m*D + i, h] = data[c, i, picks[c, h, m]].
    """
    if data.device.type == "cpu":
        return sample_gather_t_ref(data, picks)
    C, D, K = data.shape
    H, k = picks.shape[1:]
    _build.check_cuda("data", data, torch.float32, (C, D, K))
    _build.check_cuda("picks", picks, torch.int32, (C, H, k))
    if C * H >= 1 << 31:
        raise ValueError("sample_gather_t: C * H must be below 2^31")
    out = torch.empty((C, k * D, H), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        _build.launch("sample_gather_t", data.data_ptr(), picks.data_ptr(),
                      out.data_ptr(), C, D, K, H, k)
    return out


def empty_launch(C: int, H: int, device) -> None:
    """Launch a kernel that does nothing, with `sample_gather_t`'s grid and
    block for C candidates of H hypotheses: its device time is the floor of
    a launch of that shape. A measurement only; no path calls it."""
    with torch.cuda.device(device):
        _build.launch("empty", C, H)


def sample_gather_perm_t_ref(data, picks, order):
    """Plain version:
    out[c, m*D + i, h] = data[c, i, order[c, picks[c, h, m]]]."""
    C, D, K = data.shape
    H, k = picks.shape[1:]
    p = picks.long().reshape(C, H * k).clamp(0, K - 1)
    j = torch.gather(order.long(), 1, p).clamp(0, K - 1)
    g = torch.gather(data, 2, j[:, None, :].expand(C, D, H * k))
    return g.reshape(C, D, H, k).permute(0, 3, 1, 2).reshape(C, k * D, H)


def sample_gather_perm_t(data: torch.Tensor, picks: torch.Tensor,
                         order: torch.Tensor,
                         inv_order: torch.Tensor) -> torch.Tensor:
    """Permuted minimal-sample gather, hypothesis-minor.

    data: (C, D, K) f32 SoA; picks: (C, H, k) int32 indices into the
    PERMUTED space; order: (C, K) int32, the permutation; inv_order:
    (C, K) int32, its inverse (part of the contract; a gather by index
    needs only `order`).
    Returns (C, k * D, H):
    out[c, m*D + i, h] = data[c, i, order[c, picks[c, h, m]]]
    — neither data[:, order] nor order[picks] is materialized on the card.
    """
    if data.device.type == "cpu":
        return sample_gather_perm_t_ref(data, picks, order)
    C, D, K = data.shape
    H, k = picks.shape[1:]
    _build.check_cuda("data", data, torch.float32, (C, D, K))
    _build.check_cuda("picks", picks, torch.int32, (C, H, k))
    _build.check_cuda("order", order, torch.int32, (C, K))
    _build.check_cuda("inv_order", inv_order, torch.int32, (C, K))
    if C > 65535 or k > 65535:
        raise ValueError("sample_gather_perm_t: C and k at most 65535")
    out = torch.empty((C, k * D, H), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        _build.launch("sample_gather_perm_t", data.data_ptr(),
                      picks.data_ptr(), order.data_ptr(), out.data_ptr(),
                      C, D, K, H, k)
    return out


def permute_cols_ref(data, idx):
    """Plain version: out[c, :, j] = data[c, :, idx[c, j]]."""
    C, D, Kin = data.shape
    j = idx.long().clamp(0, Kin - 1)
    return torch.gather(data, 2, j[:, None, :].expand(C, D, -1))


def permute_cols(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Column gather: out[c, :, j] = data[c, :, idx[c, j]] — aligns matched
    target bearings/landmarks to query order before RANSAC.

    data: (C, D, Kin) f32; idx: (C, Kout) int32 in [0, Kin).
    Returns (C, D, Kout)."""
    if data.device.type == "cpu":
        return permute_cols_ref(data, idx)
    C, D, Kin = data.shape
    Kout = idx.shape[1]
    _build.check_cuda("data", data, torch.float32, (C, D, Kin))
    _build.check_cuda("idx", idx, torch.int32, (C, Kout))
    if C > 65535:
        raise ValueError("permute_cols: C at most 65535")
    out = torch.empty((C, D, Kout), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        _build.launch("permute_cols", data.data_ptr(), idx.data_ptr(),
                      out.data_ptr(), C, D, Kin, Kout)
    return out
