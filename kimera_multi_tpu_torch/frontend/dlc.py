"""Front-end configuration, loop-closure records and the pose-graph
assembly (the `FrontendConfig`, `VerifiedLC` and
`build_pose_graph_from_loops` of the JAX package's frontend/dlc.py; its
sequential orchestrator `DistributedFrontend` is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import backend
from ..core.containers import (
    EDGE_ODOMETRY,
    EDGE_PRIVATE_LC,
    EDGE_SHARED_LC,
    PoseGraphEdges,
)
from .lcd import LcdParams


class FrontendConfig(NamedTuple):
    lcd: LcdParams = LcdParams()
    bow_capacity: int = 128  # words per BoW vector
    lowe_ratio: float = 0.7
    ransac_hyp: int = 500
    mono_threshold: float = 1e-6
    stereo_threshold: float = 0.3
    min_mono_inliers: int = 10
    min_stereo_inliers: int = 5
    kappa_lc: float = 1e4
    tau_lc: float = 1e2
    kappa_odo: float = 1e4
    tau_odo: float = 1e2
    min_intra_separation: int = 10  # skip near-diagonal self matches
    # 5-pt minimal mono gate by default (ransac_essential_5pt), as in the
    # JAX package; use_5pt=False takes the 8-point gate
    use_5pt: bool = True
    base_seed: int = 0


class VerifiedLC(NamedTuple):
    robot_a: int
    frame_a: int
    robot_b: int
    frame_b: int
    R: np.ndarray  # T^a_b (pose of b's frame expressed in a)
    t: np.ndarray
    mono_inliers: int
    stereo_inliers: int
    bow_score: float
    status: int
    accepted: bool


def build_pose_graph_from_loops(loops, R_odo: np.ndarray, t_odo: np.ndarray,
                                cfg: FrontendConfig,
                                edge_capacity: int | None = None,
                                device="cuda") -> PoseGraphEdges:
    """Odometry + committed loop-closure edges as the back-end's
    PoseGraphEdges (the request_pose_graph service): every robot's
    odometry steps (r, k) -> (r, k + 1) in order, then the loops in
    order, typed private (same robot) or shared; capacity the next power
    of two of the count (at least 8) unless given. Assembled on the host,
    then one copy to `device` (the card unless told otherwise)."""
    dev = backend.resolve_device(device)
    R_odo = np.asarray(R_odo, np.float32)
    t_odo = np.asarray(t_odo, np.float32)
    n_r, n_s = R_odo.shape[0], R_odo.shape[1]
    rr, kk = np.meshgrid(np.arange(n_r), np.arange(n_s), indexing="ij")
    n_odo, n_lc = n_r * n_s, len(loops)
    E = n_odo + n_lc
    cap = edge_capacity or int(2 ** np.ceil(np.log2(max(E, 8))))
    cols = np.zeros((cap, 4), np.int32)
    Rm = np.broadcast_to(np.eye(3, dtype=np.float32), (cap, 3, 3)).copy()
    tm = np.zeros((cap, 3), np.float32)
    et = np.zeros(cap, np.int32)
    cols[:n_odo] = np.stack([rr.ravel(), kk.ravel(), rr.ravel(),
                             kk.ravel() + 1], axis=1)
    Rm[:n_odo] = R_odo.reshape(-1, 3, 3)
    tm[:n_odo] = t_odo.reshape(-1, 3)
    et[:n_odo] = EDGE_ODOMETRY
    if n_lc:
        cols[n_odo:E] = [(lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b)
                         for lc in loops]
        Rm[n_odo:E] = np.stack([np.asarray(lc.R, np.float32)
                                for lc in loops])
        tm[n_odo:E] = np.stack([np.asarray(lc.t, np.float32)
                                for lc in loops])
        et[n_odo:E] = np.where(cols[n_odo:E, 0] == cols[n_odo:E, 2],
                               EDGE_PRIVATE_LC, EDGE_SHARED_LC)
    kap = np.zeros(cap, np.float32)
    tau = np.zeros(cap, np.float32)
    kap[:n_odo], tau[:n_odo] = cfg.kappa_odo, cfg.tau_odo
    kap[n_odo:E], tau[n_odo:E] = cfg.kappa_lc, cfg.tau_lc
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return PoseGraphEdges(
        src_robot=f(cols[:, 0]), src_pose=f(cols[:, 1]),
        dst_robot=f(cols[:, 2]), dst_pose=f(cols[:, 3]), R=f(Rm), t=f(tm),
        kappa=f(kap), tau=f(tau), etype=f(et))
