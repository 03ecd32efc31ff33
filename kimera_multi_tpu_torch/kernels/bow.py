"""Bag-of-Words scoring.

Role of DBoW2's L1 scoring (use_nss 1, alpha 0.4, min_nss_factor 0.05 in
the reference's LcdParams.yaml). Between L1-normalized sparse vectors

    s(v, w) = 1 - 0.5 * |v - w|_1 = sum_i min(v_i, w_i)

over the shared support. A query's (word id, weight) list is sorted once
and every database entry's word ids are looked up in it by binary search
(`torch.searchsorted`), batched over queries and database entries: no
vocabulary-sized dense arrays, no inverted index.

Sums of weights are accumulated in float64 and rounded once to float32.
A float64 sum of n float32 terms is exact while the largest nonzero term
is less than 2^(29 - log2 n) times the smallest (2^22 for a BoW vector of
128 words); the float32 result then does not depend on the order of
summation, so the card and the CPU give the same scores and detections
that compare scores do not change with the device. A score's terms are
weights of its two vectors, so the condition is one on the vectors: the
ratio of a vector's largest nonzero weight to its smallest, which tf-idf
weights exceed only when a word's idf is near 0 (a word in nearly every
training descriptor). The test vocabularies and worlds stay far inside
it (tests/test_torch_vocab.py checks); outside it, card and CPU scores
may differ in the last float32 bit.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
_SENTINEL = 2**30  # padding id of a sorted query: above every word id


def sum_f32(x: torch.Tensor, dim: int = -1, keepdim: bool = False):
    """float32 sum of float32 terms, accumulated in float64."""
    return torch.sum(x, dim=dim, keepdim=keepdim,
                     dtype=torch.float64).to(torch.float32)


def normalize_l1(weights: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    w = torch.where(valid, weights, 0.0)
    return w / torch.clamp(sum_f32(w, keepdim=True), min=_EPS)


def sort_bow(word_ids: torch.Tensor, weights: torch.Tensor):
    """Sort padded BoW vectors (..., W) by word id. The padding id -1
    becomes a sentinel above every id, so it sorts last and a binary
    search never lands on it. The sort is stable: only the sentinels tie."""
    ids = torch.where(word_ids >= 0, word_ids,
                      torch.full_like(word_ids, _SENTINEL))
    ids, order = torch.sort(ids, dim=-1, stable=True)
    return ids, torch.gather(weights, -1, order)


def l1_scores(q_ids_sorted: torch.Tensor, q_weights: torch.Tensor,
              db_ids: torch.Tensor, db_weights: torch.Tensor,
              db_frame_valid: torch.Tensor) -> torch.Tensor:
    """Scores of query BoW vectors against databases of N BoW vectors.

    q_ids_sorted (..., W) ascending int32 word ids (sentinel-padded, from
    `sort_bow`); q_weights (..., W) aligned with them; db_ids (..., N, Wd)
    int32 (-1 padding); db_weights (..., N, Wd) L1-normalized;
    db_frame_valid (..., N) bool. Leading dimensions broadcast. Returns
    (..., N) float32 scores in [0, 1], 0 for invalid frames.
    """
    W = q_ids_sorted.shape[-1]
    N, Wd = db_ids.shape[-2:]
    batch = torch.broadcast_shapes(q_ids_sorted.shape[:-1],
                                   q_weights.shape[:-1], db_ids.shape[:-2],
                                   db_weights.shape[:-2])
    q = q_ids_sorted.expand(*batch, W).reshape(-1, W).contiguous()
    qw = q_weights.expand(*batch, W).reshape(-1, W)
    flat = db_ids.expand(*batch, N, Wd).reshape(q.shape[0], N * Wd)
    pos = torch.searchsorted(q, flat.contiguous())  # side="left"
    pos = torch.clamp(pos, 0, W - 1)
    hit = (torch.gather(q, 1, pos) == flat) & (flat >= 0)
    qwm = torch.where(hit, torch.gather(qw, 1, pos), 0.0)
    qwm = qwm.reshape(*batch, N, Wd)
    contrib = torch.minimum(qwm, torch.where(db_ids >= 0, db_weights, 0.0))
    return torch.where(db_frame_valid, sum_f32(contrib), 0.0)


def nss_normalized_scores(scores: torch.Tensor, nss_factor,
                          min_nss_factor: float = 0.05) -> torch.Tensor:
    """Normalized similarity score (DBoW2 `use_nss`): raw scores over the
    query's similarity to its own previous keyframe (`nss_factor`), zero
    where that factor is below `min_nss_factor` (an unreliable frame)."""
    nss_factor = torch.as_tensor(nss_factor, dtype=scores.dtype,
                                 device=scores.device)
    good = nss_factor >= min_nss_factor
    return torch.where(good, scores / torch.clamp(nss_factor, min=_EPS), 0.0)
