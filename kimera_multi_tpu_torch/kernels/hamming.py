"""Hamming-distance descriptor matching.

Role of the ORB brute-force matcher of the system this one is modelled on
(knnMatch with k = 2 and Lowe's ratio test at 0.7): packed 256-bit ORB
descriptors (K, 32) uint8, for every query descriptor the nearest and
second-nearest target, accepted when d1 < ratio * d2.

Two paths with identical results. The plain PyTorch version unpacks the
descriptors to {0,1} bit matrices and takes the Hamming distance matrix as
ham(a, b) = |a| + |b| - 2 a.b, exact in float32. The CUDA kernel
(csrc/hamming.cu) works on the packed words with XOR + POPC and never
forms the distance matrix. `knn2_lowe_match_pairs` launches the kernel for
CUDA tensors and takes the plain version for CPU tensors only.
"""

from __future__ import annotations

import torch

from . import _build

_NO_MATCH = 512  # distance given to an invalid target: beyond any real one


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) bits in {0, 1} (uint8), LSB-first per
    byte (matches numpy.unpackbits(bitorder='little'))."""
    bits = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=desc.device)
    b = (desc[..., :, None] & bits) > 0
    return b.reshape(*desc.shape[:-1], desc.shape[-1] * 8).to(torch.uint8)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Full Hamming distance matrix between packed descriptor sets.

    desc_a: (..., Ka, 32) uint8; desc_b: (..., Kb, 32) uint8
    -> (..., Ka, Kb) int32. Sums of {0,1} products up to 256 are exact in
    float32.
    """
    A = unpack_bits(desc_a).to(torch.float32)
    B = unpack_bits(desc_b).to(torch.float32)
    ra = torch.sum(A, dim=-1)
    rb = torch.sum(B, dim=-1)
    ab = A @ B.transpose(-1, -2)
    d = ra[..., :, None] + rb[..., None, :] - 2.0 * ab
    return d.to(torch.int32)


def _pair_top2_ref(desc_q, desc_t, valid_t):
    """Plain version of the pair kernel: per query row the best and
    second-best distance and the best index over the valid targets.
    desc_q (C, Kq, 32), desc_t (C, Kt, 32) uint8; valid_t (C, Kt) bool.
    Returns (d1, d2, i1), each (C, Kq) int32. Invalid targets count as
    distance 512; the first of equal distances wins."""
    D = hamming_matrix(desc_q, desc_t)
    D = torch.where(valid_t[:, None, :], D, _NO_MATCH)
    Kt = D.shape[-1]
    d1 = torch.min(D, dim=-1).values
    cols = torch.arange(Kt, device=D.device)
    i1 = torch.min(torch.where(D == d1[..., None], cols, Kt), dim=-1).values
    D2 = torch.where(cols == i1[..., None], _NO_MATCH, D)
    d2 = torch.min(D2, dim=-1).values
    return d1.to(torch.int32), d2.to(torch.int32), i1.to(torch.int32)


def _pair_top2(desc_q, desc_t, valid_t):
    """The CUDA pair kernel (csrc/hamming.cu); same contract as
    `_pair_top2_ref`, tensors on the card."""
    C, Kq, _ = desc_q.shape
    Kt = desc_t.shape[1]
    _build.check_cuda("desc_q", desc_q, torch.uint8, (C, Kq, 32))
    _build.check_cuda("desc_t", desc_t, torch.uint8, (C, Kt, 32))
    _build.check_cuda("valid_t", valid_t, torch.bool, (C, Kt))
    if C > 65535:
        raise ValueError("pair_top2: at most 65535 pairs per launch")
    if desc_q.data_ptr() % 16 or desc_t.data_ptr() % 16:
        raise ValueError("pair_top2: descriptors must be 16-byte aligned")
    d1 = torch.empty((C, Kq), dtype=torch.int32, device=desc_q.device)
    d2 = torch.empty_like(d1)
    i1 = torch.empty_like(d1)
    with torch.cuda.device(desc_q.device):
        _build.launch("pair_top2", desc_q.data_ptr(), desc_t.data_ptr(),
                      valid_t.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                      i1.data_ptr(), C, Kq, Kt)
    return d1, d2, i1


def _lowe(d1, d2, i1, valid_q, lowe_ratio, max_distance):
    d1f = d1.to(torch.float32)
    ok = (
        valid_q
        & (d1f < lowe_ratio * d2.to(torch.float32))
        & (d1 <= int(max_distance))
        & (d1 < _NO_MATCH)
    )
    return torch.where(ok, i1, -1).to(torch.int32), d1


def knn2_lowe_match(desc_q, valid_q, desc_t, valid_t, lowe_ratio: float = 0.7,
                    max_distance: int = 256):
    """2-NN matching with Lowe ratio test over a candidate axis, plain
    PyTorch: desc_* (C, K, 32) uint8, valid_* (C, K) bool.

    Returns (match_idx (C, Kq) int32 — index into the target, -1 if
    rejected; match_dist (C, Kq) int32, 512 where no target is valid).
    """
    d1, d2, i1 = _pair_top2_ref(desc_q, desc_t, valid_t)
    return _lowe(d1, d2, i1, valid_q, lowe_ratio, max_distance)


def knn2_lowe_match_pairs(desc_q, valid_q, desc_t, valid_t,
                          lowe_ratio: float = 0.7, max_distance: int = 256):
    """Batched pair matching: same contract and results as
    `knn2_lowe_match`. Tensors on the card go through the CUDA pair kernel
    (one launch for all C pairs); CPU tensors through the plain version."""
    if desc_q.device.type == "cpu":
        return knn2_lowe_match(desc_q, valid_q, desc_t, valid_t,
                               lowe_ratio, max_distance)
    d1, d2, i1 = _pair_top2(desc_q, desc_t, valid_t)
    return _lowe(d1, d2, i1, valid_q, lowe_ratio, max_distance)
