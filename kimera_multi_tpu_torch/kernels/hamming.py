"""Hamming-distance descriptor matching.

Role of the ORB brute-force matcher of the system this one is modelled on
(knnMatch with k = 2 and Lowe's ratio test at 0.7): packed 256-bit ORB
descriptors (K, 32) uint8, for every query descriptor the nearest and
second-nearest target, accepted when d1 < ratio * d2.

Two paths with identical results. The plain PyTorch version unpacks the
descriptors to {0,1} bit matrices and takes the Hamming distance matrix as
ham(a, b) = |a| + |b| - 2 a.b, exact in float32. The CUDA kernels
(csrc/hamming.cu) never form the distance matrix in memory: the pair
kernel takes the same product on the int8 tensor cores and keeps a top-2
of unique integer keys in registers, the DB-wide kernel works on packed
words with XOR + POPC. `knn2_lowe_match_pairs` (per candidate pair) and
`hamming_top2_pallas` (one query set against a whole database) launch
their kernels for CUDA tensors and take the plain versions for CPU tensors
only.
"""

from __future__ import annotations

import torch

from . import _build

_NO_MATCH = 512  # distance given to an invalid target: beyond any real one
_PAIR_MAX_KT = 1 << 21  # targets the pair kernel's keys hold (column bits)


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
    if Kt > _PAIR_MAX_KT:
        raise ValueError(f"pair_top2: at most {_PAIR_MAX_KT} targets (the "
                         f"column bits of the kernel's keys), got {Kt}")
    _build.check_cuda("desc_q", desc_q, torch.uint8, (C, Kq, 32))
    _build.check_cuda("desc_t", desc_t, torch.uint8, (C, Kt, 32))
    _build.check_cuda("valid_t", valid_t, torch.bool, (C, Kt))
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


def knn2_lowe_match_batch(desc_q, valid_q, desc_t, valid_t, lowe_ratio=0.7):
    """`knn2_lowe_match` over a leading candidate-pair axis, under the JAX
    package's name for its vmapped variant."""
    return knn2_lowe_match(desc_q, valid_q, desc_t, valid_t, lowe_ratio)


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


# ---------------------------------------------------------------------------
# DB-wide top-2 search: one query set against a large database of {0,1}
# bit rows (the detection-side "one new keyframe against every descriptor
# the fleet holds" search).
# ---------------------------------------------------------------------------

_TOP2_NONE = 1e9  # d1 / d2 of a query that saw fewer than 1 / 2 targets
_TOP2_TILE = 256  # target rows the CUDA kernel stages per pass
_TOP2_QUERIES = 512  # queries per block of the CUDA kernel


def _top2_merge(a, b):
    """Merge two partial (d1, d2, i1) results, `a` over earlier targets
    than `b`: d2 keeps multiplicity, and the strict `<` keeps the first
    index of the least distance (the JAX kernel's merge across tiles)."""
    od1, od2, oi1 = a
    nd1, nd2, ni1 = b
    return (torch.minimum(od1, nd1),
            torch.minimum(torch.maximum(od1, nd1), torch.minimum(od2, nd2)),
            torch.where(nd1 < od1, ni1, oi1))


def _hamming_top2_ref(bits_q, bits_t, chunk: int = 65536):
    """Plain version of `hamming_top2_pallas`: the distance matrix over
    chunks of `chunk` targets as |a| + |b| - 2 a.b in float32 (exact for
    {0,1} rows of 256), top-2 per chunk, chunks merged in order. Returns
    d1, d2 (Kq,) float32 and i1 (Kq,) int32 — d2 with multiplicity, i1 the
    first index of the least distance."""
    Kq, Kt = bits_q.shape[0], bits_t.shape[0]
    dev = bits_q.device
    q = bits_q.to(torch.float32)
    rq = torch.sum(q, dim=-1, keepdim=True)
    res = (torch.full((Kq,), _TOP2_NONE, device=dev),
           torch.full((Kq,), _TOP2_NONE, device=dev),
           torch.full((Kq,), -1, dtype=torch.int32, device=dev))
    for lo in range(0, Kt, chunk):
        t = bits_t[lo:lo + chunk].to(torch.float32)
        D = rq + torch.sum(t, dim=-1)[None, :] - 2.0 * (q @ t.T)
        n = t.shape[0]
        cols = torch.arange(n, device=dev)
        d1 = torch.min(D, dim=-1).values
        i1 = torch.min(torch.where(D == d1[:, None], cols, n), dim=-1).values
        if n > 1:
            d2 = torch.min(torch.where(cols == i1[:, None], _TOP2_NONE, D),
                           dim=-1).values
        else:
            d2 = torch.full_like(d1, _TOP2_NONE)
        res = _top2_merge(res, (d1, d2, (i1 + lo).to(torch.int32)))
    return res


def top2_split_rows(Kq: int, Kt: int, n_splits: int | None = None,
                    device=None) -> int:
    """Target rows per split of the CUDA kernel: the target axis is cut
    into contiguous splits of whole staging tiles, enough of them (with the
    query blocks) to give every SM of the card several blocks, unless
    `n_splits` says how many."""
    n_tiles = -(-Kt // _TOP2_TILE)
    if n_splits is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        q_blocks = -(-Kq // _TOP2_QUERIES)
        n_splits = max(1, (8 * sms) // q_blocks)
    n_splits = max(1, min(n_splits, n_tiles, 65535))
    return -(-n_tiles // n_splits) * _TOP2_TILE


def _hamming_top2(bits_q, bits_t, n_splits: int | None = None):
    """The CUDA DB-wide top-2 kernel (csrc/hamming.cu), tensors on the
    card: each block scans one split of the targets for up to 512 queries,
    a second kernel merges the splits' partial results in split order."""
    Kq, Kt = bits_q.shape[0], bits_t.shape[0]
    _build.check_cuda("bits_q", bits_q, torch.bfloat16, (Kq, 256))
    _build.check_cuda("bits_t", bits_t, torch.bfloat16, (Kt, 256))
    if bits_q.data_ptr() % 16 or bits_t.data_ptr() % 16:
        raise ValueError("hamming_top2: bit rows must be 16-byte aligned")
    dev = bits_q.device
    rows = top2_split_rows(Kq, Kt, n_splits, dev)
    S = -(-Kt // rows)
    part = torch.empty((3, S, Kq), dtype=torch.int32, device=dev)
    d1 = torch.empty((Kq,), dtype=torch.float32, device=dev)
    d2 = torch.empty_like(d1)
    i1 = torch.empty((Kq,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch("hamming_top2", bits_q.data_ptr(), bits_t.data_ptr(),
                      part.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                      i1.data_ptr(), Kq, Kt, rows, S)
    return d1, d2, i1


def hamming_top2_pallas(bits_q, bits_t, tile_q: int = 128,
                        tile_t: int = 512):
    """Top-2 Hamming search of every query row against a whole database:
    bits_q (Kq, 256) and bits_t (Kt, 256) are {0,1} bfloat16 matrices with
    Kq % tile_q == 0 and Kt % tile_t == 0 (ValueError otherwise; the tiles
    are checked, the CUDA kernel picks its own tiling).

    Returns (d1 (Kq,) float32, d2 (Kq,) float32, i1 (Kq,) int32): the least
    distance, the second least with multiplicity (= d1 when the least
    occurs twice), and the FIRST index that reaches d1. CUDA tensors go
    through the CUDA kernel, CPU tensors through `_hamming_top2_ref`."""
    Kq, Kt = bits_q.shape[0], bits_t.shape[0]
    if (bits_q.dim() != 2 or bits_t.dim() != 2 or bits_q.shape[1] != 256
            or bits_t.shape[1] != 256):
        raise ValueError("hamming_top2_pallas: expected (Kq, 256) and "
                         "(Kt, 256) bit matrices")
    if tile_q <= 0 or tile_t <= 0 or Kq % tile_q or Kt % tile_t:
        raise ValueError(
            f"hamming_top2_pallas: Kq={Kq} and Kt={Kt} must be multiples of "
            f"tile_q={tile_q} and tile_t={tile_t}")
    if Kq == 0 or Kt == 0:
        raise ValueError("hamming_top2_pallas: empty query or target set")
    if bits_q.device.type == "cpu":
        return _hamming_top2_ref(bits_q, bits_t)
    return _hamming_top2(bits_q, bits_t)
