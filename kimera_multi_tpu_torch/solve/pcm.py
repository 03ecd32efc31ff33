"""Pairwise consistency maximization (PCM) and inter-robot frame
initialization (the JAX package's solve/pcm.py).

Each shared loop closure proposes a relative robot-frame transform;
mutually consistent proposals form a consensus set (an approximate max
clique by masked boolean matvecs), whose mean places the pair's frame.

Two departures from the JAX package, neither of which changes a result:

  * Memory. The JAX package builds (E, E) matrices over all edges for
    every robot pair (38.7 GB of rotation distances per pair at
    E = 32,768). Here each pair's matrix covers that pair's shared edges
    only, compacted in index order (the pair's indices are found on the
    host, from one read of the edges' robots). Rows and columns outside
    the pair are all false in the JAX package and `argmax` of the degree
    takes the first maximum in both, so the membership is the same; the
    consensus mean sums the pair's edges in index order.
  * Devices. Every quantity a threshold decides on (the proposals, the
    rotation distance's trace, the translation distance) is computed with
    separate multiplies and adds in a fixed order (`lie.mat3_mul`), and
    the rotation test dR < thr is taken as cos(dR) > cos(thr), which
    needs no `acos` (whose last bit differs between the card's and the
    CPU's libraries). Degrees and supports are sums of 0/1 values, exact.
    So the card and the CPU decide the same consensus for the same
    inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import lie
from ..core.containers import EDGE_SHARED_LC, PoseGraphEdges
from .pgo import PgoParams

# rows of a pair's consistency matrix built at once (bounds the (rows, n)
# temporaries of the distance computation)
_ROW_BLOCK = 1024


def relative_frame_candidates(edges: PoseGraphEdges, params: PgoParams,
                              poses_per_robot: int):
    """For every edge, the robot-frame transform it implies:
    T_ab^e = T_a(i) * T_e * T_b(j)^{-1}, T_a(i) robot a's pose i in its
    own frame (params holds per-robot-anchored trajectories). Meaningful
    only for shared (inter-robot) edges."""
    src, dst = edges.global_ids(poses_per_robot)
    R1, t1 = lie.se3_compose(params.R[src], params.t[src], edges.R,
                             edges.t)
    Rjinv, tjinv = lie.se3_inverse(params.R[dst], params.t[dst])
    return lie.se3_compose(R1, t1, Rjinv, tjinv)


def consistency_matrix(R_ab: torch.Tensor, t_ab: torch.Tensor,
                       mask: torch.Tensor, rot_thresh: float = 0.3,
                       trans_thresh: float = 1.5) -> torch.Tensor:
    """(n, n) boolean: proposals e, f agree on the relative frame
    (rotation angle below rot_thresh and translation distance below
    trans_thresh), both in `mask`."""
    n = R_ab.shape[0]
    cos_thr = math.cos(float(np.float32(rot_thresh)))
    Rf = R_ab.reshape(n, 9)
    out = torch.zeros((n, n), dtype=torch.bool, device=R_ab.device)
    for lo in range(0, n, _ROW_BLOCK):
        a = Rf[lo:lo + _ROW_BLOCK, None, :]
        b = Rf[None, :, :]
        # trace(Ra^T Rb): diagonal k = (a0k b0k + a1k b1k) + a2k b2k,
        # entries k of row i at 3 i + k
        diag = [(a[..., k] * b[..., k] + a[..., 3 + k] * b[..., 3 + k])
                + a[..., 6 + k] * b[..., 6 + k] for k in range(3)]
        trace = (diag[0] + diag[1]) + diag[2]
        cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
        d = t_ab[lo:lo + _ROW_BLOCK, None, :] - t_ab[None, :, :]
        dt = torch.sqrt((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
                        + d[..., 2] * d[..., 2])
        out[lo:lo + _ROW_BLOCK] = (cos_t > cos_thr) & (dt < trans_thresh)
    return out & mask[:, None] & mask[None, :]


def max_consensus(C: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Approximate max clique: seed at the highest-degree vertex (the
    first on ties), take its neighbourhood, then prune members consistent
    with under 0.75 of the current set (boolean matvecs, exact in
    float32). Returns the (n,) membership mask."""
    Cf = C.to(torch.float32)
    deg = torch.sum(Cf, dim=1)
    m = C[torch.argmax(deg)]
    for _ in range(iters):
        mf = m.to(torch.float32)
        support = Cf @ mf  # consistency count with current members
        need = 0.75 * torch.clamp(torch.sum(mf), min=1.0)
        m = m & (support >= need)
    # the clique is only meaningful if the seed has a neighbour
    return m & (deg > 0)


def robot_frame_init(edges: PoseGraphEdges, params_local: PgoParams,
                     n_robots: int, poses_per_robot: int,
                     rot_thresh: float = 0.3, trans_thresh: float = 1.5):
    """Place every robot's locally anchored trajectory into a common world
    frame by PCM consensus over shared loop closures.

    params_local: trajectories with each robot anchored at the identity
    (e.g. from odometry composition). Returns (params_world,
    consensus_mask (E,), frame_ok (n_robots,)). Robots no consensus set
    reaches keep identity frames (frame_ok False)."""
    dev, dt = edges.R.device, edges.R.dtype
    R_ab, t_ab = relative_frame_candidates(edges, params_local,
                                           poses_per_robot)
    Rinv, tinv = lie.se3_inverse(R_ab, t_ab)
    shared = (edges.valid & (edges.etype == EDGE_SHARED_LC)).cpu().numpy()
    sr = edges.src_robot.cpu().numpy()
    dr = edges.dst_robot.cpu().numpy()

    E = edges.capacity
    eye = torch.eye(3, dtype=dt, device=dev)
    consensus_all = torch.zeros((E,), dtype=torch.bool, device=dev)
    Rw = [eye] + [None] * (n_robots - 1)
    tw = [torch.zeros(3, dtype=dt, device=dev)] + [None] * (n_robots - 1)
    ok = [torch.ones((), dtype=torch.bool, device=dev)] + [None] * (
        n_robots - 1)
    for b in range(1, n_robots):
        best_count = torch.zeros((), dtype=torch.int64, device=dev)
        best_R, best_t = eye, torch.zeros(3, dtype=dt, device=dev)
        best_mask = torch.zeros((E,), dtype=torch.bool, device=dev)
        for a in range(b):
            # edges between a and b, either direction; canonical a -> b
            bwd_np = shared & (sr == b) & (dr == a)
            pair = np.nonzero(bwd_np | (shared & (sr == a) & (dr == b)))[0]
            if len(pair) == 0:
                continue  # count 0: never taken
            idx = torch.from_numpy(pair).to(dev)
            bwd = torch.from_numpy(bwd_np[pair]).to(dev)
            Rp = torch.where(bwd[:, None, None], Rinv[idx], R_ab[idx])
            tp = torch.where(bwd[:, None], tinv[idx], t_ab[idx])
            C = consistency_matrix(Rp, tp, torch.ones_like(bwd),
                                   rot_thresh, trans_thresh)
            m = max_consensus(C)
            count = torch.sum(m)
            # consensus mean: chordal rotation mean + translation mean
            w = m.to(dt)
            sw = torch.clamp(torch.sum(w), min=1.0)
            Rm = lie.so3_project(torch.einsum("e,eij->ij", w, Rp) / sw)
            tm = torch.einsum("e,ei->i", w, tp) / sw
            Rwb, twb = lie.se3_compose(Rw[a], tw[a], Rm, tm)
            take = (count > best_count) & ok[a] & (count >= 2)
            best_R = torch.where(take, Rwb, best_R)
            best_t = torch.where(take, twb, best_t)
            m_all = torch.zeros((E,), dtype=torch.bool, device=dev)
            m_all[idx] = m
            best_mask = torch.where(take, m_all, best_mask)
            best_count = torch.where(take, count, best_count)
        got = best_count >= 2
        Rw[b] = torch.where(got, best_R, eye)
        tw[b] = torch.where(got, best_t, 0.0)
        ok[b] = got
        consensus_all = consensus_all | best_mask

    # each robot's local trajectory into the world frame
    robot_of_pose = torch.arange(n_robots, device=dev).repeat_interleave(
        poses_per_robot)
    Rg = torch.stack(Rw)[robot_of_pose]
    tg = torch.stack(tw)[robot_of_pose]
    R_world, t_world = lie.se3_compose(Rg, tg, params_local.R,
                                       params_local.t)
    return (PgoParams(R=R_world, t=t_world), consensus_all,
            torch.stack(ok))
