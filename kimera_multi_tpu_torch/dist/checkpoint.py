"""Checkpoint / resume of distributed rounds (the JAX package's
dist/checkpoint.py).

The reference has no true checkpointing: it dumps trajectories every 10 s
and restarts dpgo from scratch per instance. Here the whole round state
(lifted poses Y, GNC mu / weights / barc2 / outer iteration, the active
mask, the round index) is saved, so a run resumes mid-optimization. The
file holds the JAX package's keys and dtypes (Y, weights, mu, barc2
float32; active bool; outer_iter, round_idx int32), so a file written by
one package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.containers import GncState
from .rounds import RoundState


def save(path: str, state: RoundState) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    g = state.gnc_state
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)
    np.savez_compressed(
        path,
        Y=f32(state.Y),
        active=state.active.cpu().numpy().astype(bool),
        mu=f32(g.mu),
        weights=f32(g.weights),
        barc2=f32(g.barc2),
        outer_iter=np.asarray(g.outer_iter.cpu().numpy(), np.int32),
        round_idx=np.asarray(state.round_idx, np.int32),
    )


def load(path: str, device="cpu") -> RoundState:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)
    return RoundState(
        Y=t(z["Y"], torch.float32),
        active=t(z["active"], torch.bool),
        gnc_state=GncState(mu=t(z["mu"], torch.float32),
                           weights=t(z["weights"], torch.float32),
                           barc2=t(z["barc2"], torch.float32),
                           outer_iter=t(z["outer_iter"], torch.int32)),
        round_idx=int(z["round_idx"]))
