"""Intra-robot tensor parallelism: RANSAC hypothesis sharding (the JAX
package's dist/sharded_verify.py).

The hypothesis table of a 3d-3d RANSAC is split over the ranks of a
group: every rank draws the same full table, keeps its contiguous slice
of n_hyp / W hypotheses, solves and scores it (the rigid counts K8 on
the card), and sends its winner as 14 floats (count, global index, R, t).
One all_gather brings every rank's winner; the merge and the consensus
refit are replicated. Each hypothesis's solve and count do not depend on
the other hypotheses of its batch, so the counts equal those of the
unsplit table and the result equals `ransac_arun`'s bit for bit.

The merge rests on the first-maximum rule: `score.first_argmax` gives
each slice's first maximum, and the first rank (in rank order, so the
lowest global index) holding the largest count wins, as the first
maximum of the unsplit table does. (The JAX package keys its merge by
count - index x 1e-9, a term float32 drops for every count of 1 or more;
its result too comes from the gather's rank order.)

`arun_slice` is one rank's body as a function of (rank, world), so that
the slices can also be computed one after another in one process.
"""

from __future__ import annotations

import torch

from ..kernels import ransac, score
from .mesh import RobotGroup


def arun_slice(key, p, q, valid, rank: int, world: int, n_hyp: int = 512,
               threshold: float = 0.3) -> torch.Tensor:
    """Rank `rank` of `world`'s share of the split table: key (C, 2), p, q
    (C, 3, K) SoA points, valid (C, K). Returns (C, 14) float32 rows
    [count, global hypothesis index, R (9, row-major), t (3)] of the
    slice's first best hypothesis."""
    if n_hyp % world:
        raise ValueError(f"{world} ranks do not divide {n_hyp} hypotheses")
    h = n_hyp // world
    picks, order, inv_order = ransac._masked_sample_parts(key, valid,
                                                          n_hyp, 3)
    picks = picks[:, rank * h:(rank + 1) * h].contiguous()
    R_h, t_h, ok_h = ransac.solve_arun_hyps(p, q, picks, order, inv_order)
    counts = score.rigid_counts(R_h.contiguous(), t_h.contiguous(), p, q,
                                valid, threshold) * ok_h
    best = score.first_argmax(counts)
    C = counts.shape[0]
    rows = torch.arange(C, device=counts.device)
    return torch.cat([
        counts[rows, best][:, None].to(torch.float32),
        (rank * h + best)[:, None].to(torch.float32),
        R_h[rows, best].reshape(C, 9),
        t_h[rows, best],
    ], dim=1)


def merge_slices(cands: torch.Tensor, p, q, valid, threshold: float = 0.3,
                 min_inliers: int = 5) -> dict:
    """cands (W, C, 14): every rank's `arun_slice` in rank order. The
    first rank holding the largest count wins; then `ransac_arun`'s
    consensus refit (`ransac.arun_consensus`)."""
    W, C = cands.shape[:2]
    win = score.first_argmax(cands[..., 0].T)  # (C,) rank
    best = cands[win, torch.arange(C, device=cands.device)]
    return ransac.arun_consensus(p, q, valid, best[:, 2:11].reshape(C, 3, 3),
                                 best[:, 11:14], threshold, min_inliers)


def make_sharded_arun(group: RobotGroup, n_hyp: int = 512,
                      threshold: float = 0.3, min_inliers: int = 5):
    """A 3d-3d RANSAC over the group's ranks with `ransac_arun`'s
    semantics: run(key (C, 2), p, q (C, 3, K), valid (C, K)) -> dict(R,
    t, inliers, n_inliers, ok), the same on every rank. n_hyp must be
    divisible by the group's size."""

    def run(key, p, q, valid):
        cand = arun_slice(key, p, q, valid, group.rank, group.world, n_hyp,
                          threshold)
        cands = group.all_gather(cand[None])
        return merge_slices(cands, p, q, valid, threshold, min_inliers)

    return run
