"""Bulk-synchronous distributed RBCD rounds over a robot group (the JAX
package's dist/rounds.py).

The deterministic replacement for dpgo_ros's leader-coordinated command
state machine: REQUEST_POSE_GRAPH becomes array construction, INITIALIZE
becomes lifting + anchoring, UPDATE commands become rounds, UPDATE_WEIGHT
a replicated GNC step, TERMINATE rounding + log writing. The active-robot
mask (dist/fault.py) covers SET_ACTIVE_ROBOTS / RECOVER.

Collective schedule of one round, over the group's ranks (each owns a
set of robots: a contiguous block over torch.distributed, dist/mesh.py,
or every P-th robot over the pods' fabric, dist/dcn.py), per inner
cycle:
  1. all_gather the owned lifted blocks and active flags (separator
     exchange);
  2. the owned robots' block Newton directions, as one batched call over
     them (the JAX package's per-robot `fori_loop`);
  3. all_gather the directions; every rank runs the same global chord
     step on the gathered state and keeps its own slice (an inactive
     robot's block unchanged);
then one all_gather of the final blocks, from which every rank computes
the same cost and, every `weight_update_every` rounds after the burn-in,
the same GNC weights. Whether a round updates the weights is decided on
the host from the Python round counter (the JAX package's `lax.cond`),
with no read from the device.

`RoundState.Y` holds the whole fleet's blocks, the same on every rank
after a round (the final gather), so that checkpoints, dumps and
rounding need no further exchange.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.containers import GncState, PoseGraphEdges
from ..solve import gnc, rbcd
from .mesh import RobotGroup


class RoundState(NamedTuple):
    Y: torch.Tensor  # (R, N, r, d+1), the same on every rank
    active: torch.Tensor  # (R,) bool
    gnc_state: GncState
    round_idx: int  # rounds done


def make_round_fn(group: RobotGroup, edges: PoseGraphEdges,
                  poses_per_robot: int, cfg: rbcd.RbcdConfig,
                  weight_update_every: int = 3, mu_factor: float = 1.4,
                  burnin_rounds: int = 6,
                  buckets: rbcd.EdgeBuckets | None = None):
    """A function advancing a `RoundState` by one bulk-synchronous round:
    round_fn(state) -> (state, cost). Its rounds are
    `rbcd.rbcd_round_reference` over the bucketed edges plus the periodic
    GNC update; on a group of one rank the same operations on the same
    tensors, so the same bits. A robot whose `active` flag is False keeps
    its block exactly (the reference round re-projects it onto the
    manifold)."""
    if buckets is None:
        buckets = rbcd.bucket_edges(edges, group.n_robots, poses_per_robot)
    own = torch.tensor(group.owned, device=edges.R.device)
    own_b = rbcd.bucket_slice(buckets, own)

    def sq_errors(Y):
        return rbcd.lifted_edge_sq_errors(Y.reshape(-1, *Y.shape[2:]),
                                          edges, poses_per_robot)

    def round_fn(state: RoundState):
        weights = state.gnc_state.weights
        n_poses = state.Y.shape[1]
        # the block-Jacobi preconditioner depends only on the edges and
        # weights: once a round, reused by every inner cycle
        blk = rbcd._bucket_block(own, own_b, weights[own_b.idx])
        Minv = (rbcd.bucket_precond(own_b, own, weights, n_poses)
                if cfg.precond else None)
        Yl = state.Y[own]
        act_l = state.active[own].to(torch.uint8)
        for _ in range(cfg.inner_iters):
            # separator exchange: gather every rank's blocks and flags
            Y_all = group.all_gather(Yl)
            act_all = group.all_gather(act_l).bool()
            d = rbcd._newton_cg(blk, Yl, Y_all, cfg, Minv)
            d = torch.where(act_all[own, None, None, None], d, 0.0)
            # gather the proposals; the replicated global line search
            # gives the same bits on every rank; keep this rank's slice
            deltas_all = group.all_gather(d)
            Y_next = rbcd._global_step(Y_all, deltas_all, edges, weights,
                                       poses_per_robot, cfg)
            # a deactivated robot's block stays as it was, bit for bit
            # (the retraction would re-project it)
            Yl = torch.where(act_all[own, None, None, None],
                             Y_next[own], Yl)
        Y_full = group.all_gather(Yl)
        cost = rbcd.lifted_cost(Y_full.reshape(-1, *Y_full.shape[2:]),
                                edges, weights, poses_per_robot)
        # GNC weight round after the burn-in (the reference runs UPDATE
        # rounds between UPDATE_WEIGHT commands)
        k = state.round_idx + 1
        g = state.gnc_state
        if k % weight_update_every == 0 and k >= burnin_rounds:
            g = gnc.gnc_update_weights(g, sq_errors(Y_full), edges.etype,
                                       edges.valid, mu_factor=mu_factor)
        return RoundState(Y=Y_full, active=state.active, gnc_state=g,
                          round_idx=k), cost

    return round_fn


def round_comm_bytes(Y_shape, inner_iters: int) -> int:
    """ANALYTIC per-robot bytes received per round over the collective
    schedule (one robot a rank): per inner cycle the other robots' blocks
    (Y), active flags and proposed deltas, plus the final gather of the
    blocks."""
    R, N, r, dp1 = Y_shape
    block = N * r * dp1 * 4  # f32
    per_cycle = (R - 1) * (2 * block + 1)  # Y + deltas + active
    final = (R - 1) * block
    return inner_iters * per_cycle + final


def measured_round_comm_bytes(received: float, Y_shape, world: int,
                              inner_iters: int) -> int:
    """Bytes RECEIVED by one rank in one round: `received`, the group's
    count (`RobotGroup.received`) read before and after a round. The
    group counts per collective (ring algorithms over W ranks): all_gather
    (W - 1) / W x output bytes, all_reduce 2 (W - 1) / W x payload bytes.
    A GNC weight update adds no collective, so every round counts the
    same.

    Sanity band against the analytic model (the JAX package's rule):
    with more than one robot, a count of 0 (one rank owns the whole
    fleet) or one outside [analytic / 20, 20 x analytic] raises
    ValueError; the caller then falls back to `round_comm_bytes` and
    logs why."""
    analytic = round_comm_bytes(tuple(Y_shape), inner_iters)
    R = Y_shape[0]
    if R > 1:
        if received <= 0:
            raise ValueError(
                f"the collectives delivered no bytes in a {R}-robot round "
                f"over {world} rank(s): one rank owns the whole fleet")
        if not analytic / 20.0 <= received <= analytic * 20.0:
            raise ValueError(
                f"counted comm bytes {int(received)} outside the sanity "
                f"band of the analytic model {analytic} (20x either way)")
    return int(received)


def init_state(Y0: torch.Tensor, active: torch.Tensor,
               edges: PoseGraphEdges, poses_per_robot: int,
               gnc_alpha: float = 0.9,
               init_weights: torch.Tensor | None = None) -> RoundState:
    """INITIALIZE: GNC seeded from the residuals at Y0 (reference:
    INITIALIZE command + first weights); `init_weights` lets a PCM
    consensus pre-filter shared edges. Every rank calls it on the same
    Y0."""
    barc2 = gnc.barc2_from_quantile(gnc_alpha, dof=6)
    sq = rbcd.lifted_edge_sq_errors(Y0.reshape(-1, *Y0.shape[2:]), edges,
                                    poses_per_robot)
    g0 = gnc.gnc_init(sq, edges.etype, edges.valid, barc2)
    if init_weights is not None:
        g0 = GncState(mu=g0.mu, weights=init_weights, barc2=g0.barc2,
                      outer_iter=g0.outer_iter)
    return RoundState(Y=Y0, active=active, gnc_state=g0, round_idx=0)


def lifted_start(params0, edges: PoseGraphEdges, n_robots: int,
                 poses_per_robot: int, seed: int):
    """The rounds' starting point (the JAX package's sharded back-end and
    pods): PCM consensus places every robot's odometry-anchored
    trajectory `params0` in a common frame, shared loops outside the
    consensus start at weight 0, and the placement is lifted with the
    seed's LIFTING key (rank 5). Returns (Y0, w0, consensus, frame_ok)."""
    from ..core import rng, stiefel
    from ..core.containers import EDGE_SHARED_LC
    from ..solve import pcm

    dev = edges.R.device
    params_w, consensus, frame_ok = pcm.robot_frame_init(
        edges, params0, n_robots, poses_per_robot)
    shared = edges.valid & (edges.etype == EDGE_SHARED_LC)
    w0 = torch.where(shared & ~consensus, 0.0,
                     torch.ones(edges.capacity, device=dev))
    ylift = stiefel.random_lifting_matrix(
        rng.derive(rng.base_key(seed, device=dev), rng.Stream.LIFTING), 5, 3)
    Y0 = rbcd.lift_params(params_w, ylift, n_robots, poses_per_robot)
    return Y0, w0, consensus, frame_ok
