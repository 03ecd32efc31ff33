"""Robust PGO: Gauss-Newton solves interleaved with GNC-TLS weight
updates (the JAX package's solve/robust.py).

PCM consensus places each robot pair's relative frame (GNC alone cannot
when a pair's loop closures are majority-outlier); then Gauss-Newton
refines under GNC-TLS continuation. The JAX package's `lax.scan` over the
outer iterations is a Python loop here; the graph's incidence table is
built once, so the loop reads nothing back to the host.
"""

from __future__ import annotations

import torch

from ..core.backend import synced_clock
from ..core.containers import EDGE_SHARED_LC, GncState, PoseGraphEdges
from . import gnc, pcm, pgo
from .incidence import edge_incidence


def robust_pgo(params0: pgo.PgoParams, edges: PoseGraphEdges,
               poses_per_robot: int, gnc_outer_iters: int = 40,
               gn_iters: int = 8, cg_iters: int = 40,
               gnc_alpha: float = 0.9, mu_factor: float = 1.4,
               damping: float = 1e-4, info: dict | None = None):
    """Returns (params, GncState) after `gnc_outer_iters` weight updates
    (the reference iterates until UpdateCount >= NumWeightUpdates).

    params0 must hold per-robot-anchored trajectories (odometry init).
    info: when a dict is given, it receives PCM's `consensus` (E,) and
    `frame_ok` (n_robots,), and the PCM and whole-call times in seconds
    (`pcm_s`, `robust_pgo_s`, each on a synchronised clock)."""
    dev = params0.R.device
    t0 = synced_clock(dev) if info is not None else 0.0
    barc2 = gnc.barc2_from_quantile(gnc_alpha, dof=6)
    n_total = params0.R.shape[0]
    n_robots = n_total // poses_per_robot

    params_w, consensus, frame_ok = pcm.robot_frame_init(
        edges, params0, n_robots, poses_per_robot)
    if info is not None:
        info.update(consensus=consensus, frame_ok=frame_ok,
                    pcm_s=synced_clock(dev) - t0)
    shared = edges.valid & (edges.etype == EDGE_SHARED_LC)
    w0 = torch.where(shared & ~consensus, 0.0,
                     torch.ones(edges.capacity, dtype=params0.t.dtype,
                                device=dev))
    inc = edge_incidence(edges, poses_per_robot, n_total)

    # refine from the PCM placement (not from scratch: the placement is
    # the hard-won part); non-consensus shared edges start at weight 0 but
    # GNC can re-admit them once their residuals say so
    params = pgo.gauss_newton(params_w, edges, w0, poses_per_robot,
                              gn_iters=gn_iters, cg_iters=cg_iters,
                              damping=damping, inc=inc)
    sq = pgo.edge_squared_errors(params, edges, poses_per_robot)
    state: GncState = gnc.gnc_init(sq, edges.etype, edges.valid, barc2)
    for _ in range(gnc_outer_iters):
        sq = pgo.edge_squared_errors(params, edges, poses_per_robot)
        state = gnc.gnc_update_weights(state, sq, edges.etype, edges.valid,
                                       mu_factor=mu_factor)
        params = pgo.gauss_newton(params, edges, state.weights,
                                  poses_per_robot, gn_iters=gn_iters,
                                  cg_iters=cg_iters, damping=damping,
                                  inc=inc)
    if info is not None:
        info["robust_pgo_s"] = synced_clock(dev) - t0
    return params, state
