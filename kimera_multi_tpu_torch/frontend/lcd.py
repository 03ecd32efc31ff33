"""Loop-closure detection: BoW scoring -> islands -> temporal constraint
-> candidate selection.

Role of Kimera-VIO's `LoopClosureDetector::detectLoop` (nss score ->
computeIslands -> checkTemporalConstraint) and kimera_multi_lcd's
inter-robot variants. Parameters from the reference's LcdParams.yaml:
use_nss 1, alpha 0.4, min_nss_factor 0.05, max_db_results 50,
recent_frames_window 100, max_intraisland_gap 3,
max_nrFrames_between_islands 3, min_temporal_matches 1.

Islands over the frame axis come from cumsum segment labels and scatter
reductions, batched over any leading axes (every (query robot, target
robot) row of a detection step at once). Every choice among equal values
is made the way the JAX package makes it — the lower index first — and
the same on the card as on the CPU: `_topk` is a stable descending sort,
island sums are accumulated in float64 (exact: at most
max_db_results members, each between alpha and 1 / min_nss_factor, so
the order of the scatter's additions does not matter), maxima and minima
are order-independent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.bow import _EPS
from .bow_db import BowDatabase, query as db_query


class LcdParams(NamedTuple):
    alpha: float = 0.4  # score threshold factor (x nss factor)
    min_nss_factor: float = 0.05
    max_db_results: int = 50
    recent_frames_window: int = 100
    max_intraisland_gap: int = 3
    max_nrFrames_between_islands: int = 3
    min_temporal_matches: int = 1
    use_nss: bool = True


class DetectionResult(NamedTuple):
    match_id: torch.Tensor  # () int32, -1 if no detection
    island_score: torch.Tensor  # () float32
    best_score: torch.Tensor  # () float32 (nss-normalized best score)
    detected: torch.Tensor  # () bool


def normalize_scores(scores: torch.Tensor, nss_factor,
                     params: LcdParams) -> torch.Tensor:
    """nss normalization (use_nss: 1): s' = s / nss_factor, zero where
    nss_factor < min_nss_factor."""
    if params.use_nss:
        nss_factor = torch.as_tensor(nss_factor, dtype=scores.dtype,
                                     device=scores.device)
        ok_nss = nss_factor >= params.min_nss_factor
        return torch.where(ok_nss,
                           scores / torch.clamp(nss_factor, min=_EPS), 0.0)
    return scores


def _topk(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; `torch.topk` leaves the order of ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_islands(norm_scores: torch.Tensor, params: LcdParams,
                n_cand: int = 1):
    """Islands over nss-normalized scores (..., N) (computeIslands): the
    alpha gate and the max_db_results cap, accepted frames with gaps <=
    max_intraisland_gap merged into islands scored by their sum, each
    island represented by its first member of maximal score.

    Returns (match_ids (..., n_cand) int32 — representative frame per
    island, -1 beyond the last island; island_scores (..., n_cand) float32
    descending; valid (..., n_cand) bool). n_cand = 1 is the reference's
    single best island; n_cand > 1 the candidate-list mode."""
    N = norm_scores.shape[-1]
    dev = norm_scores.device
    accept = norm_scores >= params.alpha
    k = min(params.max_db_results, N)
    kth = _topk(norm_scores, k)[0][..., -1:]
    accept = accept & (norm_scores >= torch.clamp(kth, min=_EPS))

    frame_has = accept
    idx = torch.arange(N, device=dev)
    window_any = torch.zeros_like(frame_has)
    for g in range(1, params.max_intraisland_gap + 1):
        # `&` binds before `|`, as in the JAX expression
        window_any = window_any | (torch.roll(frame_has, g, dims=-1)
                                   & (idx >= g))
    island_start = frame_has & ~window_any
    island_id = torch.cumsum(island_start.to(torch.int64), dim=-1) - 1
    island_id = torch.where(frame_has, island_id, N - 1)

    member = torch.where(frame_has, norm_scores, 0.0)
    island_scores = torch.zeros(member.shape, dtype=torch.float64,
                                device=dev).scatter_add_(
        -1, island_id, member.to(torch.float64)).to(torch.float32)
    member_best = torch.zeros_like(member).scatter_reduce_(
        -1, island_id, member, "amax", include_self=True)
    is_rep = frame_has & (
        norm_scores >= torch.gather(member_best, -1, island_id) - 1e-9)
    rep_idx = torch.full(member.shape, N, dtype=torch.int64,
                         device=dev).scatter_reduce_(
        -1, torch.where(is_rep, island_id, N - 1),
        torch.where(is_rep, idx, N), "amin", include_self=True)

    c = min(n_cand, N)
    best_scores, best_islands = _topk(island_scores, c)
    matches = torch.gather(rep_idx, -1, best_islands)
    valid = (best_scores > 0.0) & (matches < N)
    out_m = torch.where(valid, matches, -1).to(torch.int32)
    if c < n_cand:
        pad = (*out_m.shape[:-1], n_cand - c)
        out_m = torch.cat([out_m, torch.full(pad, -1, dtype=torch.int32,
                                             device=dev)], -1)
        best_scores = torch.cat([best_scores, torch.zeros(pad, device=dev)],
                                -1)
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)], -1)
    return out_m, best_scores, valid


def temporal_gate(match: torch.Tensor, valid: torch.Tensor,
                  prev_island: torch.Tensor, consec: torch.Tensor,
                  params: LcdParams):
    """The temporal constraint across consecutive queries of a (query
    robot, target robot) pair (checkTemporalConstraint), elementwise over
    any shape of pairs. match, valid: each pair's best island this query
    and whether it was detected; prev_island (-1 = none), consec: the
    previous best island and the count of consecutive consistent
    detections. A detection passes once min_temporal_matches of them in a
    row had their islands within max_nrFrames_between_islands of the one
    before. Returns (gate, prev_island, consec), the last two the new
    state."""
    if params.min_temporal_matches > 1:
        close = (prev_island >= 0) & (
            torch.abs(match - prev_island)
            <= params.max_nrFrames_between_islands)
        consec_new = torch.where(valid, torch.where(close, consec + 1, 1), 0)
        gate = valid & (consec_new >= params.min_temporal_matches)
    else:
        consec_new = torch.where(valid, consec + 1, 0)
        gate = valid
    return gate, torch.where(valid, match, -1), consec_new


def detect(db: BowDatabase, q_ids_sorted: torch.Tensor,
           q_weights: torch.Tensor, nss_factor, params: LcdParams,
           self_query_frame=None, prev_island_frame=None) -> DetectionResult:
    """One detection pass of a query BoW against one database.

    self_query_frame: if set (intra-robot query), frames within
    recent_frames_window of it are excluded. prev_island_frame: the
    representative of the previous query's best island, for the temporal
    check (-1 = no history; only read when min_temporal_matches > 1).
    """
    exclude_after = None
    if self_query_frame is not None:
        exclude_after = self_query_frame - params.recent_frames_window + 1
    scores = db_query(db, q_ids_sorted, q_weights, exclude_after)
    norm_scores = normalize_scores(scores, nss_factor, params)

    matches, island_scores, valid = top_islands(norm_scores, params, 1)
    match, best_island_score = matches[0], island_scores[0]

    if prev_island_frame is not None and params.min_temporal_matches > 1:
        prev = torch.as_tensor(prev_island_frame, device=match.device)
        temporal_ok = (prev >= 0) & (
            torch.abs(match - prev) <= params.max_nrFrames_between_islands)
    else:
        temporal_ok = torch.ones((), dtype=torch.bool, device=match.device)

    detected = valid[0] & temporal_ok
    return DetectionResult(
        match_id=torch.where(detected, match, -1).to(torch.int32),
        island_score=best_island_score,
        best_score=torch.max(norm_scores),
        detected=detected,
    )
