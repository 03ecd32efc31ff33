"""Deterministic sums onto poses.

The JAX package scatter-adds per-edge contributions onto the poses they
touch. A float `index_add_` on the card is an atomic whose result depends
on the order the contributions arrive in, so the port lists, on the host,
the slots that touch each pose in increasing slot order, as a padded
(rows, poses, D) table; a reduction gathers along it and sums over the
fixed D axis. Two runs on the card then give the same bits. Used by the
RBCD round (`rbcd.py`), Gauss-Newton (`pgo.py`) and chordal
initialization (`chordal.py`).
"""

from __future__ import annotations

import numpy as np
import torch


def incidence_np(rob2: np.ndarray, idx2: np.ndarray, ok2: np.ndarray,
                 robots, n_poses: int) -> np.ndarray:
    """Host: for each robot of `robots` (row b: robot robots[b]), the slots
    s with ok2[b, s] & rob2[b, s] == robots[b] grouped by pose idx2[b, s],
    in increasing s, as an (R, n_poses, D) table padded with S (the
    number of slots)."""
    n_rows, S = rob2.shape
    groups = []
    for b, r in enumerate(robots):
        s = np.nonzero(ok2[b] & (rob2[b] == r))[0]
        p = idx2[b, s].astype(np.int64)
        if len(p) and (p.min() < 0 or p.max() >= n_poses):
            raise ValueError(f"pose index outside [0, {n_poses})")
        order = np.argsort(p, kind="stable")
        groups.append((s[order], p[order]))
    D = max([1] + [int(np.bincount(p, minlength=1).max())
                   for _, p in groups if len(p)])
    table = np.full((n_rows, n_poses, D), S, np.int64)
    for b, (s, p) in enumerate(groups):
        if len(p):
            first = np.searchsorted(p, p, side="left")
            table[b, p, np.arange(len(p)) - first] = s
    return table


def reduce_onto_poses(contrib: torch.Tensor, inc: torch.Tensor,
                      n_poses: int) -> torch.Tensor:
    """Sum slot contributions (B, 2S, ...) onto own poses along the
    incidence table (B, P, D): a gather, then a sum over the fixed D
    axis. Returns (B, n_poses, ...)."""
    B, P, D = inc.shape
    if P != n_poses:
        raise ValueError(f"incidence table covers {P} poses, blocks hold "
                         f"{n_poses}")
    pad = torch.zeros_like(contrib[:, :1])
    padded = torch.cat([contrib, pad], dim=1)
    rows = torch.arange(B, device=inc.device)[:, None, None]
    return torch.sum(padded[rows, inc], dim=2)


def edge_incidence(edges, poses_per_robot: int,
                   n_poses: int) -> torch.Tensor:
    """(1, n_poses, D) table over the global poses of a whole graph. Slot
    2e is edge e's source, slot 2e + 1 its destination (the order of
    `torch.stack([src, dst], 1).reshape(-1)`); invalid edges are left out.
    Built on the host from the edges, once per graph."""
    src, dst = edges.global_ids(poses_per_robot)
    idx2 = torch.stack([src, dst], dim=1).reshape(1, -1).cpu().numpy()
    ok2 = torch.stack([edges.valid, edges.valid],
                      dim=1).reshape(1, -1).cpu().numpy()
    table = incidence_np(np.zeros_like(idx2), idx2, ok2, [0], n_poses)
    return torch.from_numpy(table).to(edges.R.device)
