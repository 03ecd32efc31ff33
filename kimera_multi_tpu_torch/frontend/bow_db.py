"""Per-robot BoW database of fixed capacity.

Role of DBoW2's database and kimera_multi_lcd's per-robot BoW stores
("all vs self" detection variants). Frame `i` of a robot sits in row `i`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.backend import resolve_device
from ..kernels import bow as bow_kernel


class BowDatabase(NamedTuple):
    word_ids: torch.Tensor  # (N, W) int32, -1 padded
    weights: torch.Tensor  # (N, W) float32, L1-normalized
    frame_valid: torch.Tensor  # (N,) bool
    count: torch.Tensor  # () int32 — frames inserted (may exceed N)

    @property
    def capacity(self) -> int:
        return self.word_ids.shape[0]


def empty(n_frames: int, words_per_frame: int,
          device="cuda") -> BowDatabase:
    """An empty database on `device`: the card unless the caller asks for
    the CPU (raises if the card is asked for and there is none)."""
    device = resolve_device(device)
    return BowDatabase(
        word_ids=torch.full((n_frames, words_per_frame), -1,
                            dtype=torch.int32, device=device),
        weights=torch.zeros((n_frames, words_per_frame), device=device),
        frame_valid=torch.zeros((n_frames,), dtype=torch.bool,
                                device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def add(db: BowDatabase, frame_id: int, word_ids: torch.Tensor,
        weights: torch.Tensor) -> BowDatabase:
    """Insert a frame's BoW vector at `frame_id`; returns a new database
    (the arguments are not modified)."""
    ids, w, fv = db.word_ids.clone(), db.weights.clone(), db.frame_valid.clone()
    ids[frame_id] = word_ids
    w[frame_id] = weights
    fv[frame_id] = True
    count = torch.clamp(db.count, min=int(frame_id) + 1)
    return BowDatabase(ids, w, fv, count)


def query(db: BowDatabase, q_ids: torch.Tensor, q_weights: torch.Tensor,
          exclude_after=None) -> torch.Tensor:
    """L1 scores of a sorted query (`sort_bow`) against every frame;
    frames with id >= `exclude_after` are masked (the reference's
    recent_frames_window for self-queries)."""
    valid = db.frame_valid
    if exclude_after is not None:
        frames = torch.arange(db.capacity, device=valid.device)
        valid = valid & (frames < torch.as_tensor(exclude_after,
                                                  device=valid.device))
    return bow_kernel.l1_scores(q_ids, q_weights, db.word_ids, db.weights,
                                valid)
