"""Rank-lifted Riemannian block-coordinate descent (the JAX package's
solve/rbcd.py).

Pose blocks are lifted to St(d, r) x R^r and every robot updates its own
block against last round's neighbours (parallel, Jacobi-style RBCD): a
block Newton direction by preconditioned CG, then one exact-chord global
step, retracted onto the manifold. Robots are a batch axis: every block
function takes a leading robot axis (the JAX package vmaps them).

Autodiff is written out. The block cost is exactly quadratic in a robot's
own block, every residual linear in Y:
  r_rot = YR_j - YR_i R_ij,  r_tr = yt_j - yt_i - YR_i t_ij,
  cost  = sum_e w_e (kappa ||r_rot||^2 + tau ||r_tr||^2),
so the gradient is the residuals mapped back onto the poses (at a source
slot -2 w [kappa r_rot R^T + tau r_tr t^T | tau r_tr], at a destination
slot 2 w [kappa r_rot | tau r_tr]), and a Hessian-vector product is the
same map applied to the residuals of v with the fixed neighbours set to
zero, plus the 1e-6 v Tikhonov term. Along a chord Y + s D the cost is
c0 + b s + h s^2 / 2 with b = 2 sum_e w_e <r_e(Y), r_e(D)>_(kappa, tau)
and h = 2 cost(D).

Reductions onto poses are deterministic. The JAX package scatter-adds
the slots of its one concatenated src+dst gather onto the poses; a float
`index_add_` on the card is an atomic whose result depends on the order
the slots arrive in. Here (`incidence.py`) the slots that touch each
own pose are listed on the host, in increasing slot order, as a padded
(robots, poses, D) table; a reduction gathers along it and sums over the
fixed D axis. So two runs on the card give the same bits. The bucketed
path builds its table once per graph (`EdgeBuckets.inc`, at
`bucket_edges` time) and reads nothing back to the host inside a round;
the masked O(E_total) path builds its table (`masked_incidence`) from
the edges on each call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import stiefel
from ..core.containers import PoseGraphEdges
from .incidence import incidence_np as _incidence_np
from .incidence import reduce_onto_poses as _reduce_onto_poses
from .pgo import PgoParams

_EPS = 1e-12
_D = 3  # pose dimension


class EdgeBuckets(NamedTuple):
    """Per-robot edge buckets: the edges touching each robot, gathered into
    dense padded (R, Em) arrays so a block update is O(E_robot). `inc`
    (R, P, D) lists, for each own pose, the slots of the concatenated
    src+dst gather (in [0, 2 Em)) that touch it, padded with 2 Em."""

    idx: torch.Tensor  # (R, Em) int64 index into the flat edge arrays
    valid: torch.Tensor  # (R, Em) bool
    src_robot: torch.Tensor  # (R, Em) int32
    src_pose: torch.Tensor  # (R, Em) int32
    dst_robot: torch.Tensor  # (R, Em) int32
    dst_pose: torch.Tensor  # (R, Em) int32
    R: torch.Tensor  # (R, Em, 3, 3)
    t: torch.Tensor  # (R, Em, 3)
    kappa: torch.Tensor  # (R, Em)
    tau: torch.Tensor  # (R, Em)
    inc: torch.Tensor  # (R, P, D) int64


def bucket_edges(edges: PoseGraphEdges, n_robots: int, poses_per_robot: int,
                 pad_multiple: int = 8) -> EdgeBuckets:
    """Host-side bucketing, once per graph. Every valid edge lands in the
    bucket of each robot it touches (a shared loop closure in two), and
    each bucket's incidence table over the robot's `poses_per_robot`
    poses is built here."""
    sr = edges.src_robot.cpu().numpy()
    dr = edges.dst_robot.cpu().numpy()
    sp = edges.src_pose.cpu().numpy()
    dp = edges.dst_pose.cpu().numpy()
    valid = edges.valid.cpu().numpy()
    per_robot = [np.nonzero(valid & ((sr == r) | (dr == r)))[0]
                 for r in range(n_robots)]
    em = max((len(ix) for ix in per_robot), default=1)
    em = max(pad_multiple, int(np.ceil(em / pad_multiple)) * pad_multiple)
    idx = np.zeros((n_robots, em), np.int64)
    bval = np.zeros((n_robots, em), bool)
    for r, ix in enumerate(per_robot):
        idx[r, : len(ix)] = ix
        bval[r, : len(ix)] = True
    inc = _incidence_np(np.concatenate([sr[idx], dr[idx]], axis=1),
                        np.concatenate([sp[idx], dp[idx]], axis=1),
                        np.concatenate([bval, bval], axis=1),
                        range(n_robots), poses_per_robot)
    dev = edges.R.device
    gi = torch.from_numpy(idx).to(dev)
    return EdgeBuckets(
        idx=gi, valid=torch.from_numpy(bval).to(dev),
        src_robot=edges.src_robot[gi], src_pose=edges.src_pose[gi],
        dst_robot=edges.dst_robot[gi], dst_pose=edges.dst_pose[gi],
        R=edges.R[gi], t=edges.t[gi], kappa=edges.kappa[gi],
        tau=edges.tau[gi], inc=torch.from_numpy(inc).to(dev))


def bucket_slice(buckets: EdgeBuckets, r) -> EdgeBuckets:
    """The buckets of robot(s) `r`: an int gives one robot's fields
    (Em, ...), an index tensor a batch of them."""
    return EdgeBuckets(*(a[r] for a in buckets))


def masked_incidence(edges: PoseGraphEdges, robots: torch.Tensor,
                     n_poses: int) -> torch.Tensor:
    """(B, n_poses, D) incidence table of the unbucketed path: for each
    robot of `robots` (B,) and own pose, the slots of the concatenated
    src+dst gather over ALL edges (in [0, 2 E)) that touch it, padded
    with 2 E. Built on the host from the edges."""
    rob2 = torch.cat([edges.src_robot, edges.dst_robot]).cpu().numpy()
    idx2 = torch.cat([edges.src_pose, edges.dst_pose]).cpu().numpy()
    ok2 = torch.cat([edges.valid, edges.valid]).cpu().numpy()
    rows = robots.cpu().tolist()
    shape = (len(rows), len(rob2))
    inc = _incidence_np(np.broadcast_to(rob2, shape),
                        np.broadcast_to(idx2, shape),
                        np.broadcast_to(ok2, shape), rows, n_poses)
    return torch.from_numpy(inc).to(edges.R.device)


class RbcdConfig(NamedTuple):
    rank: int = 5  # staircase rank r (> d = 3)
    inner_iters: int = 3  # (direction -> global step) cycles per round
    cg_iters: int = 8  # PCG iterations for the block Newton solve
    step_init: float = 1.0  # cap on the exact-chord step (s* <= 4x this)
    precond: bool = True  # block-Jacobi (per-pose 4x4) PCG


def lift_params(params: PgoParams, ylift: torch.Tensor, n_robots: int,
                poses_per_robot: int) -> torch.Tensor:
    """SE(3) params -> lifted blocks Y (R, N, r, d+1) through the shared
    lifting matrix."""
    Y = stiefel.lift_poses(params.R, params.t, ylift)
    return Y.reshape(n_robots, poses_per_robot, ylift.shape[0], _D + 1)


def _residuals(Yi, Yj, R_e, t_e):
    """r_rot (..., r, 3) and r_tr (..., r) of edges with endpoint blocks
    Yi, Yj (..., r, 4) and measurements R_e (..., 3, 3), t_e (..., 3)."""
    YRi = Yi[..., :_D]
    r_rot = Yj[..., :_D] - YRi @ R_e
    r_tr = Yj[..., _D] - Yi[..., _D] - (YRi @ t_e[..., None])[..., 0]
    return r_rot, r_tr


def _edge_terms(r_rot, r_tr, kappa, tau):
    return (torch.sum(r_rot * r_rot, dim=(-1, -2)) * kappa
            + torch.sum(r_tr * r_tr, dim=-1) * tau)


def _lifted_residuals(Y_flat, edges: PoseGraphEdges, poses_per_robot: int):
    src, dst = edges.global_ids(poses_per_robot)
    return _residuals(Y_flat[..., src, :, :], Y_flat[..., dst, :, :],
                      edges.R, edges.t)


def lifted_cost(Y_flat: torch.Tensor, edges: PoseGraphEdges,
                edge_weights: torch.Tensor,
                poses_per_robot: int) -> torch.Tensor:
    """f(Y) = sum_e w_e [kappa ||YR_j - YR_i R_ij||^2
                         + tau ||yt_j - yt_i - YR_i t_ij||^2]
    for Y_flat (..., N_total, r, d+1); leading axes are a batch."""
    r_rot, r_tr = _lifted_residuals(Y_flat, edges, poses_per_robot)
    w = torch.where(edges.valid, edge_weights, 0.0)
    return torch.sum(w * _edge_terms(r_rot, r_tr, edges.kappa, edges.tau),
                     dim=-1)


def lifted_edge_sq_errors(Y_flat: torch.Tensor, edges: PoseGraphEdges,
                          poses_per_robot: int) -> torch.Tensor:
    """Per-edge whitened squared error in the lifted space (the GNC r^2;
    at rank d it equals the chordal SE(3) residual)."""
    r_rot, r_tr = _lifted_residuals(Y_flat, edges, poses_per_robot)
    return _edge_terms(r_rot, r_tr, edges.kappa, edges.tau)


class _Block(NamedTuple):
    """The edges one batch of robots' block costs read, as the slots of
    the concatenated src+dst gather: S edges, 2 S slots per robot."""

    rob2: torch.Tensor  # (B, 2S) robot of each slot
    idx2: torch.Tensor  # (B, 2S) pose of each slot
    own2: torch.Tensor  # (B, 2S) slot on the batch row's own robot
    R: torch.Tensor  # (B, S, 3, 3) or (S, 3, 3)
    t: torch.Tensor  # (B, S, 3) or (S, 3)
    kappa: torch.Tensor  # (B, S) or (S,)
    tau: torch.Tensor
    ww: torch.Tensor  # (B, S) weights, 0 on invalid / untouched edges
    inc: torch.Tensor  # (B, P, D) slots onto own poses


def _bucket_block(robot, bucket: EdgeBuckets, w) -> _Block:
    """w (B, Em): the buckets' gathered edge weights."""
    rob2 = torch.cat([bucket.src_robot, bucket.dst_robot], dim=-1).long()
    idx2 = torch.cat([bucket.src_pose, bucket.dst_pose], dim=-1).long()
    return _Block(rob2, idx2, rob2 == robot[:, None], bucket.R, bucket.t,
                  bucket.kappa, bucket.tau,
                  torch.where(bucket.valid, w, 0.0), bucket.inc)


def _masked_block(robot, edges: PoseGraphEdges, edge_weights,
                  inc) -> _Block:
    rob2 = torch.cat([edges.src_robot, edges.dst_robot]).long()
    idx2 = torch.cat([edges.src_pose, edges.dst_pose]).long()
    own2 = rob2[None, :] == robot[:, None]
    E = edges.capacity
    touches = own2[:, :E] | own2[:, E:]
    ww = torch.where(edges.valid[None, :] & touches, edge_weights[None, :],
                     0.0)
    B = robot.shape[0]
    return _Block(rob2.expand(B, -1), idx2.expand(B, -1), own2, edges.R,
                  edges.t, edges.kappa, edges.tau, ww, inc)


def _gather_blocks(blk: _Block, Y_own, Y_all):
    """Endpoint blocks of every slot, (B, 2S, r, 4): the batch row's own
    block where the slot is its robot's, last round's Y_all elsewhere."""
    B, N = Y_own.shape[:2]
    rows = torch.arange(B, device=Y_own.device)[:, None]
    own = Y_own.reshape(B * N, *Y_own.shape[2:])[rows * N + blk.idx2]
    fixed = Y_all.reshape(-1, *Y_all.shape[2:])[
        blk.rob2 * Y_all.shape[1] + blk.idx2]
    return torch.where(blk.own2[..., None, None], own, fixed)


def _gather_own(blk: _Block, V):
    """Slots of the batch rows' own blocks V (B, N, r, 4), zero at the
    fixed neighbours' slots."""
    B, N = V.shape[:2]
    rows = torch.arange(B, device=V.device)[:, None]
    g = V.reshape(B * N, *V.shape[2:])[rows * N + blk.idx2]
    return torch.where(blk.own2[..., None, None], g, 0.0)


def _slot_gradient(blk: _Block, Yg):
    """d cost / d (slot blocks), (B, 2S, r, 4), of slot blocks Yg."""
    S = blk.ww.shape[-1]
    Yi, Yj = Yg[:, :S], Yg[:, S:]
    r_rot, r_tr = _residuals(Yi, Yj, blk.R, blk.t)
    a = (2.0 * blk.ww * blk.kappa)[..., None, None]
    b = (2.0 * blk.ww * blk.tau)[..., None]
    ar, br = a * r_rot, b * r_tr
    g_iR = -(ar @ blk.R.transpose(-1, -2)) - br[..., None] * blk.t[..., None, :]
    g_i = torch.cat([g_iR, -br[..., None]], dim=-1)
    g_j = torch.cat([ar, br[..., None]], dim=-1)
    return torch.cat([g_i, g_j], dim=1)


def _block_cost_of(blk: _Block, Yg):
    S = blk.ww.shape[-1]
    r_rot, r_tr = _residuals(Yg[:, :S], Yg[:, S:], blk.R, blk.t)
    return torch.sum(blk.ww * _edge_terms(r_rot, r_tr, blk.kappa, blk.tau),
                     dim=-1)


def _block_cost(Y_own, Y_all, robot, edges: PoseGraphEdges, edge_weights):
    """Cost of the edges touching each robot of `robot` (B,), its own
    block taken from Y_own (B, N, r, 4) and every other from Y_all; (B,)."""
    blk = _masked_block(robot, edges, edge_weights, None)
    return _block_cost_of(blk, _gather_blocks(blk, Y_own, Y_all))


def _block_cost_bucketed(Y_own, Y_all, robot, b: EdgeBuckets, w):
    """`_block_cost` over each robot's bucket; w (B, Em) the bucket's
    gathered edge weights."""
    blk = _bucket_block(robot, b, w)
    return _block_cost_of(blk, _gather_blocks(blk, Y_own, Y_all))


def _block_jacobi_inv(inc, own_src, own_dst, t_e, kappa, tau, w,
                      n_poses: int) -> torch.Tensor:
    """Inverted per-pose 4x4 diagonal blocks of the block Hessian,
    (B, n_poses, 4, 4).

    The block cost acts identically and independently on each of the r
    rows of a pose's block, so the Hessian is a pose-coupled matrix
    tensored with I_r. An edge (i -> j) adds, per unit row,
    2 w [kappa diag(1,1,1,0) + tau [t;1][t;1]^T] at the source pose and
    2 w [kappa diag(1,1,1,0) + tau diag(0,0,0,1)] at the destination,
    summed onto the poses along the incidence table `inc`; damped by the
    CG operator's 1e-6 Tikhonov term, so padded poses are exact."""
    dev, dt = t_e.device, t_e.dtype
    e4 = torch.eye(4, dtype=dt, device=dev)
    rot_mask = torch.diag(torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=dt,
                                       device=dev))
    u = torch.cat([t_e, torch.ones_like(t_e[..., :1])], dim=-1)
    H_src = (2.0 * w)[..., None, None] * (
        kappa[..., None, None] * rot_mask
        + tau[..., None, None] * (u[..., :, None] * u[..., None, :]))
    H_dst = (2.0 * w)[..., None, None] * (
        kappa[..., None, None] * rot_mask
        + tau[..., None, None] * (e4 - rot_mask))
    H_src = torch.where(own_src[..., None, None], H_src, 0.0)
    H_dst = torch.where(own_dst[..., None, None], H_dst, 0.0)
    B = own_src.shape[0]
    H_src = H_src.expand(B, *H_src.shape[-3:])
    H_dst = H_dst.expand(B, *H_dst.shape[-3:])
    H = _reduce_onto_poses(torch.cat([H_src, H_dst], dim=1), inc, n_poses)
    return _spd4_inv(H + 1e-6 * e4)


def _spd4_inv(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched SPD 4x4 blocks via the (3, 1) Schur
    split."""
    A = H[..., :3, :3]
    b = H[..., :3, 3]
    c = H[..., 3, 3]
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02  # > 0 (SPD + damping)
    inv_det = 1.0 / det
    Ainv = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2) * inv_det[..., None, None]
    u = (Ainv @ b[..., None])[..., 0]
    s = c - torch.sum(b * u, dim=-1)  # Schur complement > 0
    inv_s = 1.0 / s
    tl = Ainv + inv_s[..., None, None] * (u[..., :, None] * u[..., None, :])
    tr = -inv_s[..., None] * u
    top = torch.cat([tl, tr[..., :, None]], dim=-1)  # (..., 3, 4)
    bot = torch.cat([tr, inv_s[..., None]], dim=-1)[..., None, :]
    return torch.cat([top, bot], dim=-2)


def _newton_cg(blk: _Block, Y_own, Y_all, cfg: RbcdConfig,
               Minv=None) -> torch.Tensor:
    """Block Newton directions (B, N, r, 4) by (preconditioned) CG, per
    robot of the batch. The gradient is taken once at Y_own; each CG step
    applies the Hessian to p: the residuals of p's own slots (fixed
    neighbours at zero) mapped back onto the poses, plus 1e-6 p. `Minv`
    (B, N, 4, 4) from `_block_jacobi_inv` enables block-Jacobi PCG."""
    N = Y_own.shape[1]
    g = _reduce_onto_poses(
        _slot_gradient(blk, _gather_blocks(blk, Y_own, Y_all)), blk.inc, N)

    def hvp(v):
        Hv = _reduce_onto_poses(_slot_gradient(blk, _gather_own(blk, v)),
                                blk.inc, N)
        return Hv + 1e-6 * v

    if Minv is None:
        apply_M = lambda r: r
    else:
        MinvT = Minv.transpose(-1, -2)
        apply_M = lambda r: r @ MinvT

    def dot(a, b):  # per robot of the batch, broadcast back
        return torch.sum(a * b, dim=(1, 2, 3))[:, None, None, None]

    b = -g
    z0 = apply_M(b)
    x, r, p, rs = torch.zeros_like(b), b, z0, dot(b, z0)
    for _ in range(cfg.cg_iters):
        Ap = hvp(p)
        alpha = rs / torch.clamp(dot(p, Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rs2 = dot(r, z)
        p = z + (rs2 / torch.clamp(rs, min=1e-20)) * p
        rs = rs2
    return x


def bucket_precond(bucket: EdgeBuckets, robot: torch.Tensor,
                   edge_weights: torch.Tensor, n_poses: int) -> torch.Tensor:
    """(B, N, 4, 4) block-Jacobi inverses for each robot's bucket. They
    depend on the edges and weights only, not on Y: build once a round."""
    w = torch.where(bucket.valid, edge_weights[bucket.idx], 0.0)
    return _block_jacobi_inv(
        bucket.inc, (bucket.src_robot == robot[:, None]) & bucket.valid,
        (bucket.dst_robot == robot[:, None]) & bucket.valid,
        bucket.t, bucket.kappa, bucket.tau, w, n_poses)


def block_direction_bucketed(Y_own, Y_all, robot, bucket: EdgeBuckets,
                             edge_weights, cfg: RbcdConfig,
                             Minv=None) -> torch.Tensor:
    """Newton directions over each robot's edge bucket: Y_own (B, N, r, 4)
    the batch's own blocks, Y_all (R, N, r, 4) last round's, robot (B,)
    their ids, bucket their buckets (B, Em, ...). Pass `Minv` (from
    `bucket_precond`) to reuse the preconditioner across cycles."""
    if Minv is None and cfg.precond:
        Minv = bucket_precond(bucket, robot, edge_weights, Y_own.shape[1])
    blk = _bucket_block(robot, bucket, edge_weights[bucket.idx])
    return _newton_cg(blk, Y_own, Y_all, cfg, Minv)


def block_direction(Y_own, Y_all, robot, edges: PoseGraphEdges,
                    edge_weights, cfg: RbcdConfig,
                    Minv=None) -> torch.Tensor:
    """Newton directions of each robot's block over all edges, masked to
    those touching it (O(E_total); `block_direction_bucketed` computes the
    same over a bucketing)."""
    N = Y_all.shape[1]
    inc = masked_incidence(edges, robot, N)
    if Minv is None and cfg.precond:
        Minv = masked_precond(edges, robot, edge_weights, N, inc)
    blk = _masked_block(robot, edges, edge_weights, inc)
    return _newton_cg(blk, Y_own, Y_all, cfg, Minv)


def masked_precond(edges: PoseGraphEdges, robot: torch.Tensor,
                   edge_weights: torch.Tensor, n_poses: int,
                   inc: torch.Tensor | None = None) -> torch.Tensor:
    """O(E_total)-masked counterpart of `bucket_precond`; `inc` is the
    batch's rows of `masked_incidence` (built here when not given)."""
    if inc is None:
        inc = masked_incidence(edges, robot, n_poses)
    ww = torch.where(edges.valid, edge_weights, 0.0)
    return _block_jacobi_inv(
        inc, (edges.src_robot == robot[:, None]) & edges.valid,
        (edges.dst_robot == robot[:, None]) & edges.valid,
        edges.t, edges.kappa, edges.tau, ww, n_poses)


_STEP_LADDER = (1.0, 0.5, 0.25, 1.0 / 16, 1.0 / 64)


def _global_step(Y, deltas, edges: PoseGraphEdges, edge_weights,
                 poses_per_robot: int, cfg: RbcdConfig) -> torch.Tensor:
    """Accept the best point on the combined-direction chord. The cost is
    exactly quadratic along Y + s deltas, so the chord minimizer s* comes
    from b and h in closed form (module docstring); the five trial steps
    s* {1, 1/2, 1/4, 1/16, 1/64} are retracted as one batch and the least
    retracted cost is kept if it improves on c0. All on the device."""
    shp = (-1,) + Y.shape[2:]
    Yf, Df = Y.reshape(shp), deltas.reshape(shp)
    w = torch.where(edges.valid, edge_weights, 0.0)
    rY_rot, rY_tr = _lifted_residuals(Yf, edges, poses_per_robot)
    rD_rot, rD_tr = _lifted_residuals(Df, edges, poses_per_robot)
    c0 = torch.sum(w * _edge_terms(rY_rot, rY_tr, edges.kappa, edges.tau))
    b = 2.0 * torch.sum(w * (
        torch.sum(rY_rot * rD_rot, dim=(-1, -2)) * edges.kappa
        + torch.sum(rY_tr * rD_tr, dim=-1) * edges.tau))
    h = 2.0 * torch.sum(w * _edge_terms(rD_rot, rD_tr, edges.kappa,
                                        edges.tau))
    s_star = torch.where(h > _EPS, -b / torch.clamp(h, min=_EPS), 0.0)
    s_star = torch.clamp(s_star, 0.0, 4.0 * cfg.step_init)
    steps = s_star * torch.tensor(_STEP_LADDER, dtype=Y.dtype,
                                  device=Y.device)
    Yc = stiefel.lifted_retract(
        Y[None], steps[:, None, None, None, None] * deltas[None], _D)
    costs = lifted_cost(Yc.reshape((len(_STEP_LADDER),) + shp), edges,
                        edge_weights, poses_per_robot)
    best = torch.argmin(costs)
    take = (costs[best] < c0).to(Y.dtype)
    return take * Yc[best] + (1.0 - take) * Y


def rbcd_round_reference(Y, active, edges: PoseGraphEdges, edge_weights,
                         cfg: RbcdConfig, poses_per_robot: int | None = None,
                         buckets: EdgeBuckets | None = None) -> torch.Tensor:
    """`inner_iters` cycles of (parallel block Newton directions) ->
    (global damped step). With `buckets` (from `bucket_edges`) each
    direction costs O(E_robot) and nothing is read back to the host;
    without, the masked O(E_total) path runs (its incidence table is
    built from the edges on the host at the start of the call)."""
    ppr = poses_per_robot if poses_per_robot is not None else Y.shape[1]
    n_robots, n_poses = Y.shape[:2]
    robots = torch.arange(n_robots, device=Y.device)
    if buckets is not None:
        blk = _bucket_block(robots, buckets, edge_weights[buckets.idx])
        Minv = (bucket_precond(buckets, robots, edge_weights, n_poses)
                if cfg.precond else None)
    else:
        inc = masked_incidence(edges, robots, n_poses)
        blk = _masked_block(robots, edges, edge_weights, inc)
        Minv = (masked_precond(edges, robots, edge_weights, n_poses, inc)
                if cfg.precond else None)
    for _ in range(cfg.inner_iters):
        deltas = _newton_cg(blk, Y, Y, cfg, Minv)
        deltas = torch.where(active[:, None, None, None], deltas, 0.0)
        Y = _global_step(Y, deltas, edges, edge_weights, ppr, cfg)
    return Y


def solve_rounds(Y0, active, edges: PoseGraphEdges, poses_per_robot: int,
                 cfg: RbcdConfig, n_rounds: int = 30, gnc_weights=None,
                 buckets: EdgeBuckets | None = None):
    """Fixed-round RBCD loop. Returns (final Y, the lifted cost after
    each round (n_rounds,))."""
    w = (gnc_weights if gnc_weights is not None
         else torch.ones(edges.capacity, dtype=Y0.dtype, device=Y0.device))
    Y, costs = Y0, []
    for _ in range(n_rounds):
        Y = rbcd_round_reference(Y, active, edges, w, cfg, poses_per_robot,
                                 buckets)
        costs.append(lifted_cost(Y.reshape(-1, *Y.shape[2:]), edges, w,
                                 poses_per_robot))
    return Y, torch.stack(costs)
