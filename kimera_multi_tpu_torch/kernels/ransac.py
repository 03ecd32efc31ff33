"""Fixed-iteration batched RANSAC.

The verification hot path: all `n_hyp` hypotheses of every candidate are
sampled deterministically up front (counter-based draws keyed per
candidate), solved with closed-form SoA minimal solvers, and scored
against all correspondences at once. No early exit — fixed shapes, mask
semantics, identical results independent of how candidates are batched.

Every function takes a leading candidate axis C (the JAX package's
same-named functions handle one candidate and are vmapped); the CUDA
kernels below them are launched once per call, not per candidate.

Envelope: <= 500 iterations; acceptance thresholds mono >= 10, stereo >= 5
inliers.
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.lie import mat3_mul
from . import fivept, gather, minimal, score, soa


def _masked_sample_parts(key, valid: torch.Tensor, n_hyp: int, k: int,
                         u: torch.Tensor | None = None):
    """Floyd k-subset sampling over the valid entries of each candidate.

    key: (C, 2) threefry keys; valid: (C, n) bool. Returns
    (picks (C, n_hyp, k) int32 into the valid-first permutation,
     order (C, n) int32 — the stable valid-first permutation itself,
     inv_order (C, n) int32 — its inverse, in closed form from cumulative
     counts of the mask).
    `u` (C, n_hyp, k) f32 in [0, 1) replaces the draws made from `key`.

    Floyd: draw t_j ~ U[0, m-k+j] for j = 0..k-1 over the valid count m;
    if t_j collides with an earlier pick, substitute m-k+j. Requires >= k
    valid entries; with fewer, index clamping yields repeats and
    downstream degeneracy masking rejects those hypotheses.
    """
    C, n = valid.shape
    m = torch.sum(valid, dim=1, dtype=torch.int32)  # (C,) valid counts
    # a valid j ranks by the number of valid entries at or before it; an
    # invalid j ranks after all m valid ones by its position among the
    # invalid
    cv = torch.cumsum(valid, dim=1, dtype=torch.int32)
    cnv = torch.cumsum(~valid, dim=1, dtype=torch.int32)
    inv_order = torch.where(valid, cv - 1, m[:, None] + cnv - 1)
    # the permutation is the scatter of positions through its inverse
    order = torch.empty_like(inv_order)
    order.scatter_(1, inv_order.long(),
                   torch.arange(n, dtype=torch.int32,
                                device=valid.device).expand(C, n))
    if u is None:
        u = rng_mod.uniform(key, (n_hyp, k))
    picks = []
    for j in range(k):
        hi = torch.clamp(m - k + 1 + j, min=1)  # (C,) range size of draw j
        t = torch.minimum(
            (u[:, :, j] * hi.to(u.dtype)[:, None]).to(torch.int32),
            (hi - 1)[:, None])
        # collision with any earlier pick -> substitute the new top index
        coll = torch.zeros_like(t, dtype=torch.bool)
        for prev in picks:
            coll = coll | (prev == t)
        picks.append(torch.where(coll, (m - k + j)[:, None], t))
    picks = torch.clamp(torch.stack(picks, dim=-1), 0, n - 1)
    return picks.contiguous(), order, inv_order


def _masked_sample(key, valid: torch.Tensor, n_hyp: int, k: int,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """(C, n_hyp, k) distinct indices drawn only from valid positions
    (the composed form of `_masked_sample_parts`: order[picks])."""
    picks, order, _inv = _masked_sample_parts(key, valid, n_hyp, k, u)
    C = picks.shape[0]
    return torch.gather(order, 1, picks.reshape(C, -1).long()).reshape(
        picks.shape)


def _distinct(picks: torch.Tensor) -> torch.Tensor:
    """(..., H) bool — True where the sample has no repeated index."""
    srt = torch.sort(picks, dim=-1).values
    return torch.all(srt[..., 1:] != srt[..., :-1], dim=-1)


def _gather_samples(data, picks):
    """data (C, 3, K); picks (C, H, k) indices. Returns a list over the k
    sample points of SoA vec3s with (C, H) components."""
    g = gather.sample_gather_t(data, picks)  # (C, k * 3, H)
    k = picks.shape[-1]
    return [[g[:, m * 3 + i] for i in range(3)] for m in range(k)]


def _gather_samples_perm(data, picks, order, inv_order):
    """data (C, 3, K) -> list over the k sample points of SoA vec3s with
    (C, H) components, through the fused-permutation gather."""
    g = gather.sample_gather_perm_t(data, picks, order, inv_order)
    k = picks.shape[-1]
    return [[g[:, m * 3 + i] for i in range(3)] for m in range(k)]


def solve_arun_hyps(p, q, picks, order, inv_order):
    """SoA-batched minimal Arun solves for all hypotheses.

    p, q: (C, 3, K); picks: (C, H, 3) into the valid-first permutation.
    Returns (R_h (C, H, 3, 3), t_h (C, H, 3), ok_h (C, H)) with ok_h False
    for degenerate or repeated samples."""
    ps = _gather_samples_perm(p, picks, order, inv_order)
    qs = _gather_samples_perm(q, picks, order, inv_order)
    R_l, t_l, ok_h = soa.arun3(ps, qs)
    ok_h = ok_h & _distinct(picks)
    return soa.stack_mat3(R_l), soa.stack_vec(t_l), ok_h


def solve_essential_hyps(f1, f2, picks, order, inv_order):
    """SoA-batched 8-point essential solves for all hypotheses.

    f1, f2: (C, 3, K) unit bearings; picks: (C, H, 8).
    Returns (E_h (C, H, 3, 3), ok_h (C, H))."""
    s1 = _gather_samples_perm(f1, picks, order, inv_order)
    s2 = _gather_samples_perm(f2, picks, order, inv_order)
    E_l, ok_h = soa.essential8(s1, s2)
    ok_h = ok_h & _distinct(picks)
    return soa.stack_mat3(E_l), ok_h


def _take_best(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    return x[torch.arange(x.shape[0], device=x.device), best]


def ransac_arun(key, p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
                threshold: float = 0.3, n_hyp: int = 500,
                min_inliers: int = 5, refine: bool = True,
                u: torch.Tensor | None = None):
    """3d3d RANSAC with the Arun minimal solver (k = 3).

    p, q: (C, 3, K) SoA corresponding 3D points (p in frame A, q in frame
    B); valid: (C, K) mask; threshold: inlier distance in meters.
    Returns dict with R (C, 3, 3), t (C, 3) — the transform satisfying
    q ~ R p + t — inliers (C, K), n_inliers (C,), ok (C,). `u` replaces
    the sample draws (see `_masked_sample_parts`).
    """
    picks, order, inv_order = _masked_sample_parts(key, valid, n_hyp, 3, u)
    R_h, t_h, ok_h = solve_arun_hyps(p, q, picks, order, inv_order)

    # count of ||q - (R p + t)|| < threshold per hypothesis (fused kernel
    # on the card — no (C, H, K) residual tensor)
    counts = score.rigid_counts(R_h.contiguous(), t_h.contiguous(), p, q,
                                valid, threshold) * ok_h
    best = score.first_argmax(counts)
    return arun_consensus(p, q, valid, _take_best(R_h, best),
                          _take_best(t_h, best), threshold, min_inliers,
                          refine)


def arun_consensus(p, q, valid, R_b, t_b, threshold: float,
                   min_inliers: int, refine: bool = True):
    """`ransac_arun`'s result from its winning model R_b (C, 3, 3), t_b
    (C, 3): its inlier set, with `refine` a weighted re-solve on it, and
    the inlier set and count of the re-solved model."""

    def _inliers(R_b, t_b):
        r = q - (mat3_mul(R_b, p) + t_b[:, :, None])  # (C, 3, K)
        d2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
        return (d2 < threshold * threshold) & valid

    best_inl = _inliers(R_b, t_b)
    if refine:
        # weighted re-solve on the consensus set; the inlier SET is
        # recomputed afterwards so acceptance and the reported count agree
        w = best_inl.to(p.dtype)
        R_r, t_r, ok_r = minimal.arun_3d3d_soa(p, q, w)
        use = ok_r & (torch.sum(best_inl, dim=1) >= 3)
        R_b = torch.where(use[:, None, None], R_r, R_b)
        t_b = torch.where(use[:, None], t_r, t_b)
        best_inl = _inliers(R_b, t_b)
    n_inl = torch.sum(best_inl, dim=1, dtype=torch.int32)
    return {
        "R": R_b,
        "t": t_b,
        "inliers": best_inl,
        "n_inliers": n_inl,
        "ok": n_inl >= min_inliers,
    }


def ransac_essential(key, f1: torch.Tensor, f2: torch.Tensor,
                     valid: torch.Tensor, threshold: float = 1e-6,
                     n_hyp: int = 500, min_inliers: int = 10,
                     k_sample: int = 8, u: torch.Tensor | None = None):
    """2d2d monocular RANSAC: essential matrix from bearing vectors with
    the 8-point solver as hypothesis generator.

    f1, f2: (C, 3, K) SoA unit bearings; valid: (C, K); threshold: squared
    Sampson error. Returns dict with E (C, 3, 3), inliers (C, K),
    n_inliers (C,), ok (C,).
    """
    if k_sample != 8:
        raise ValueError("the SoA minimal path is specialized to k=8")
    picks, order, inv_order = _masked_sample_parts(key, valid, n_hyp,
                                                    k_sample, u)
    E_h, ok_h = solve_essential_hyps(f1, f2, picks, order, inv_order)
    counts = score.essential_counts(E_h.contiguous(), f1, f2, valid,
                                    threshold) * ok_h
    E_best = _take_best(E_h, score.first_argmax(counts))
    return _essential_result(E_best, f1, f2, valid, threshold, min_inliers)


def _essential_result(E_b, f1, f2, valid, threshold, min_inliers):
    """Inliers of the best model E_b (C, 3, 3), refit on its consensus set
    with the weighted 8-point fit (used where it succeeds on >= 8 inliers;
    the inlier SET is recomputed afterwards so acceptance and the reported
    count agree), as the result dict of the mono RANSAC functions."""
    best_inl = (minimal.sampson_error_soa(E_b, f1, f2) < threshold) & valid
    E_r, ok_r = minimal.essential_8pt_soa(f1, f2, best_inl.to(f1.dtype))
    use = ok_r & (torch.sum(best_inl, dim=1) >= 8)
    E_b = torch.where(use[:, None, None], E_r, E_b)
    best_inl = (minimal.sampson_error_soa(E_b, f1, f2) < threshold) & valid
    n_inl = torch.sum(best_inl, dim=1, dtype=torch.int32)
    return {
        "E": E_b,
        "inliers": best_inl,
        "n_inliers": n_inl,
        "ok": n_inl >= min_inliers,
    }


def ransac_essential_5pt(key, f1: torch.Tensor, f2: torch.Tensor,
                         valid: torch.Tensor, threshold: float = 1e-6,
                         n_hyp: int = 200, min_inliers: int = 10,
                         n_starts: int = 8, gn_iters: int = 8,
                         preselect_pts: int = 64, preselect_models: int = 128,
                         u: torch.Tensor | None = None):
    """2d2d monocular RANSAC with the 5-point minimal solver. Each minimal
    sample yields `n_starts` essential-matrix candidates (the solver's
    multiple roots), all of them scored.

    Scoring is preemptive: every (hypothesis, start) model is scored on
    the first `preselect_pts` VALID correspondences (the head of the
    stable valid-first permutation), each hypothesis's best start
    survives, and the `preselect_models` best hypotheses are projected
    onto the essential manifold and scored on all K points. Set
    preselect_pts=0 (or preselect_models >= n_hyp) to score exhaustively.

    f1, f2: (C, 3, K) SoA unit bearings; valid: (C, K); threshold: squared
    Sampson error. `u` replaces the sample draws (`_masked_sample_parts`).
    Returns dict with E (C, 3, 3), inliers (C, K), n_inliers (C,), ok (C,).
    """
    picks, order, inv_order = _masked_sample_parts(key, valid, n_hyp, 5, u)
    H, S = n_hyp, n_starts
    g1 = gather.sample_gather_perm_t(f1, picks, order, inv_order)  # (C,15,H)
    g2 = gather.sample_gather_perm_t(f2, picks, order, inv_order)
    E_rows = fivept.fivept_models(g1, g2, n_starts=S, gn_iters=gn_iters,
                                  project=False)              # (C, 9 S, H)
    K = f1.shape[-1]
    if preselect_pts and H > preselect_models and K > 2 * preselect_pts:
        # the preselect points are the first P entries of the valid-first
        # permutation, gathered as P one-point samples (the JAX package
        # selects them with a one-hot matrix product)
        P = preselect_pts
        head = order[:, :P, None].contiguous()                # (C, P, 1)
        f1p = gather.sample_gather_t(f1, head)                # (C, 3, P)
        f2p = gather.sample_gather_t(f2, head)
        m_valid = torch.sum(valid, dim=1, dtype=torch.int32)
        validp = (torch.arange(P, device=valid.device)[None, :]
                  < m_valid[:, None])
        counts_hs = fivept.presel_counts(E_rows, f1p, f2p, validp, threshold,
                                         S)
        E_sel_raw, _flat_idx = fivept.select_models(
            E_rows, counts_hs, preselect_models, S)
        E_sel, _okp = minimal._project_essential(E_sel_raw)
    else:
        E_sel = fivept.models_to_flat(fivept._project_rows(E_rows, S), S)
    counts = score.essential_counts(E_sel.contiguous(), f1, f2, valid,
                                    threshold)
    E_b = _take_best(E_sel, score.first_argmax(counts))
    return _essential_result(E_b, f1, f2, valid, threshold, min_inliers)


def ransac_translation_known_rotation(key, p: torch.Tensor, q: torch.Tensor,
                                      R_known: torch.Tensor,
                                      valid: torch.Tensor,
                                      threshold: float = 0.3,
                                      n_hyp: int = 200, min_inliers: int = 5,
                                      u: torch.Tensor | None = None):
    """1-point 3d3d RANSAC with a known rotation (the reference's
    `ransac_use_1point_3d3d`, rotation from the IMU): hypothesis
    t = q_i - R p_i. p, q: (C, 3, K) SoA; R_known (C, 3, 3); valid (C, K).
    Plain PyTorch (C, n_hyp, K) scoring: the JAX package reaches no kernel
    here either. Returns dict with R, t (C, 3), inliers (C, K),
    n_inliers (C,), ok (C,)."""
    idx = _masked_sample(key, valid, n_hyp, 1, u)[:, :, 0]  # (C, H)
    diff = q - R_known @ p  # (C, 3, K)
    t_h = torch.gather(diff, 2, idx[:, None, :].expand(-1, 3, -1).long())
    e = diff[:, :, None, :] - t_h[:, :, :, None]  # (C, 3, H, K)
    d2 = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
    inl = (d2 < threshold * threshold) & valid[:, None, :]
    counts = torch.sum(inl, dim=2)
    best = score.first_argmax(counts)
    best_inl = _take_best(inl, best)
    # refine: mean translation over the consensus set
    w = best_inl.to(p.dtype)[:, None, :]
    t_b = torch.sum(diff * w, dim=2) / torch.clamp(torch.sum(w, dim=2),
                                                   min=1.0)
    resid_b = diff - t_b[:, :, None]
    best_inl = (torch.sum(resid_b * resid_b, dim=1)
                < threshold * threshold) & valid
    return {
        "R": R_known,
        "t": t_b,
        "inliers": best_inl,
        "n_inliers": torch.sum(best_inl, dim=1, dtype=torch.int32),
        "ok": _take_best(counts, best) >= min_inliers,
    }
