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
from . import gather, minimal, score, soa


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis. Inlier counts are
    integers and tie often; `torch.argmax` promises no particular index
    among equal maxima on the card."""
    n = x.shape[-1]
    ar = torch.arange(n, device=x.device)
    mx = torch.max(x, dim=-1, keepdim=True).values
    return torch.min(torch.where(x == mx, ar, n), dim=-1).values


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


def _distinct(picks: torch.Tensor) -> torch.Tensor:
    """(..., H) bool — True where the sample has no repeated index."""
    srt = torch.sort(picks, dim=-1).values
    return torch.all(srt[..., 1:] != srt[..., :-1], dim=-1)


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
    best = _first_argmax(counts)
    R_b, t_b = _take_best(R_h, best), _take_best(t_h, best)

    def _inliers(R_b, t_b):
        resid = q - (R_b @ p + t_b[:, :, None])  # (C, 3, K)
        return (torch.sum(resid * resid, dim=1)
                < threshold * threshold) & valid

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
    E_best = _take_best(E_h, _first_argmax(counts))
    err0 = minimal.sampson_error_soa(E_best, f1, f2)
    best_inl = (err0 < threshold) & valid
    # refine on the consensus set (weighted 8-pt)
    E_r, ok_r = minimal.essential_8pt_soa(f1, f2, best_inl.to(f1.dtype))
    use = ok_r & (torch.sum(best_inl, dim=1) >= k_sample)
    E_b = torch.where(use[:, None, None], E_r, E_best)
    err_b = minimal.sampson_error_soa(E_b, f1, f2)
    best_inl = (err_b < threshold) & valid
    n_inl = torch.sum(best_inl, dim=1, dtype=torch.int32)
    return {
        "E": E_b,
        "inliers": best_inl,
        "n_inliers": n_inl,
        "ok": n_inl >= min_inliers,
    }
