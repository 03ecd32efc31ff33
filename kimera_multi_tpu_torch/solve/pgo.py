"""Single-block SE(3) pose-graph optimization: matrix-free Gauss-Newton
(the JAX package's solve/pgo.py).

Residuals over all edges are one batched gather and Lie operations; the
normal system is never formed: CG applies J, then J^T. The JAX package
gets both from `jax.linearize` / `jax.vjp` of the residual function of
the retraction's increment, and its J^T scatter-adds onto the poses, which
on the card is a float atomic whose sum depends on the order the terms
arrive in. Here J is written out (option (a)): per edge, the
left-perturbation Jacobians at the current poses,
  rotation    d r_rot = s_rot Jr^-1(r_rot) R_j^T (dw_j - dw_i),
  translation d r_tr  = s_tr R_i^T (hat(t_j - t_i) dw_i + dv_j - dv_i),
with Jr^-1 the inverse right Jacobian of SO(3), are formed once per
Gauss-Newton iteration as one (E, 6, 12) block, so a CG step applies J as
one gather and one batched product, and J^T as one batched product and a
sum onto the poses along an incidence table (`incidence.edge_incidence`,
built once per call from the edges, or passed in). Two card runs give the
same bits. Fixed iteration counts, no value read back to the host inside
the iterations. The gauge is fixed by a prior on pose 0; padding poses
have no factors and keep their values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.containers import EDGE_ODOMETRY, PoseGraphEdges
from .incidence import edge_incidence, reduce_onto_poses


class PgoParams(NamedTuple):
    R: torch.Tensor  # (N, 3, 3)
    t: torch.Tensor  # (N, 3)


def edge_residuals(params: PgoParams, edges: PoseGraphEdges,
                   edge_weights: torch.Tensor,
                   poses_per_robot: int) -> torch.Tensor:
    """Stacked whitened residuals (E, 6), [rot | trans] per edge:
    sqrt(w kappa) Log(R_ij^T R_i^T R_j) and
    sqrt(w tau) (R_i^T (t_j - t_i) - t_ij). Invalid edges give zeros."""
    src, dst = edges.global_ids(poses_per_robot)
    Ri, Rj = params.R[src], params.R[dst]
    ti, tj = params.t[src], params.t[dst]
    Rrel = Ri.transpose(-1, -2) @ Rj
    r_rot = lie.so3_log(edges.R.transpose(-1, -2) @ Rrel)
    r_tr = torch.einsum("eji,ej->ei", Ri, tj - ti) - edges.t
    w = torch.where(edges.valid, edge_weights, 0.0)
    s_rot = torch.sqrt(torch.clamp(w * edges.kappa, min=0.0))[:, None]
    s_tr = torch.sqrt(torch.clamp(w * edges.tau, min=0.0))[:, None]
    return torch.cat([r_rot * s_rot, r_tr * s_tr], dim=-1)


def anchor_residual(params: PgoParams, anchor_weight: float) -> torch.Tensor:
    """Gauge prior on pose 0 at the identity, (6,)."""
    s = torch.sqrt(torch.tensor(anchor_weight, dtype=params.t.dtype,
                                device=params.t.device))
    return torch.cat([lie.so3_log(params.R[0]) * s, params.t[0] * s])


def retract(params: PgoParams, delta: torch.Tensor) -> PgoParams:
    """Left-multiplicative retraction R <- Exp(dw) R, t <- t + dv, with
    delta (N, 6) = [dw | dv]."""
    dR = lie.so3_exp(delta[:, :3])
    return PgoParams(R=dR @ params.R, t=params.t + delta[:, 3:])


def _cg(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain fixed-iteration conjugate gradients with the JAX package's
    1e-20 guards."""
    x = torch.zeros_like(b)
    r, p = b, b
    rs = torch.sum(b * b)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp(rs, min=1e-20)
        p = r + beta * p
        rs = rs_new
    return x


def _jr_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) at w (..., 3):
    I + hat(w) / 2 + c hat(w)^2, c = (1 - (theta/2) cot(theta/2)) / theta^2
    (its Taylor value below theta = 1e-2)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta2s = torch.clamp(theta2, min=1e-12)
    half = torch.sqrt(theta2s) * 0.5
    c = torch.where(
        theta2 < 1e-4, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.clamp(torch.sin(half), min=1e-12)) / theta2s)
    W = lie.hat(w)
    return lie._eye_like(W) + 0.5 * W + c * (W @ W)


def _linearize(params: PgoParams, edges: PoseGraphEdges, src, dst,
               s_rot, s_tr, sa: float):
    """Residuals and their Jacobians at `params`: edge residuals r_e
    (E, 6) (= `edge_residuals`), edge Jacobians J_e (E, 6, 12) with
    columns [dw_i, dv_i, dw_j, dv_j], the anchor residual r_a (6,) and
    its Jacobian J_a (6, 6) on pose 0."""
    Ri, Rj = params.R[src], params.R[dst]
    ti, tj = params.t[src], params.t[dst]
    RiT = Ri.transpose(-1, -2)
    r_rot = lie.so3_log(edges.R.transpose(-1, -2) @ (RiT @ Rj))
    d = tj - ti
    r_tr = torch.einsum("eji,ej->ei", Ri, d) - edges.t
    sr, st = s_rot[:, None], s_tr[:, None]
    r_e = torch.cat([r_rot * sr, r_tr * st], dim=-1)
    M = sr[..., None] * (_jr_inv(r_rot) @ Rj.transpose(-1, -2))
    P = st[..., None] * RiT
    Q = P @ lie.hat(d)
    Z = torch.zeros_like(M)
    J_e = torch.cat([torch.cat([-M, Z, M, Z], dim=-1),
                     torch.cat([Q, -P, Z, P], dim=-1)], dim=-2)
    R0 = params.R[0]
    w0 = lie.so3_log(R0)
    r_a = torch.cat([w0 * sa, params.t[0] * sa])
    J_a = torch.zeros((6, 6), dtype=R0.dtype, device=R0.device)
    J_a[:3, :3] = sa * (_jr_inv(w0) @ R0.transpose(-1, -2))
    J_a[3:, 3:] = sa * torch.eye(3, dtype=R0.dtype, device=R0.device)
    return r_e, J_e, r_a, J_a


def _apply_jt(J_e: torch.Tensor, u: torch.Tensor, inc: torch.Tensor,
              n_poses: int) -> torch.Tensor:
    """J_e^T u for edge rows u (E, 6), summed onto the poses along the
    incidence table: (n_poses, 6)."""
    g = (J_e.transpose(-1, -2) @ u[..., None])[..., 0]  # (E, 12)
    return reduce_onto_poses(g.reshape(1, -1, 6), inc, n_poses)[0]


def gauss_newton(params0: PgoParams, edges: PoseGraphEdges,
                 edge_weights: torch.Tensor, poses_per_robot: int,
                 gn_iters: int = 20, cg_iters: int = 50,
                 damping: float = 1e-4,
                 anchor_weight: float = 1e4,
                 inc: torch.Tensor | None = None) -> PgoParams:
    """Damped Gauss-Newton with matrix-free CG inner solves.

    inc: the graph's incidence table (`incidence.edge_incidence(edges,
    poses_per_robot, N)`); built here from the edges when not given (one
    read of the edges back to the host)."""
    N = params0.R.shape[0]
    if inc is None:
        inc = edge_incidence(edges, poses_per_robot, N)
    src, dst = edges.global_ids(poses_per_robot)
    ids2 = torch.stack([src, dst], dim=1).reshape(-1)
    E = edges.capacity
    w = torch.where(edges.valid, edge_weights, 0.0)
    s_rot = torch.sqrt(torch.clamp(w * edges.kappa, min=0.0))
    s_tr = torch.sqrt(torch.clamp(w * edges.tau, min=0.0))
    sa = math.sqrt(anchor_weight)

    params = params0
    for _ in range(gn_iters):
        r_e, J_e, r_a, J_a = _linearize(params, edges, src, dst, s_rot,
                                        s_tr, sa)
        H_a = J_a.T @ J_a

        def matvec(v, J_e=J_e, H_a=H_a):
            Jv = (J_e @ v[ids2].reshape(E, 12, 1))[..., 0]
            out = _apply_jt(J_e, Jv, inc, N)
            out[0] += H_a @ v[0]
            return out + damping * v

        g = _apply_jt(J_e, r_e, inc, N)  # J^T r
        g[0] += J_a.T @ r_a
        params = retract(params, _cg(matvec, -g, cg_iters))
    return params


def pgo_cost(params: PgoParams, edges: PoseGraphEdges,
             edge_weights: torch.Tensor,
             poses_per_robot: int) -> torch.Tensor:
    r = edge_residuals(params, edges, edge_weights, poses_per_robot)
    return 0.5 * torch.sum(r * r)


def edge_squared_errors(params: PgoParams, edges: PoseGraphEdges,
                        poses_per_robot: int) -> torch.Tensor:
    """Unit-weight whitened squared residual per edge (the GNC r^2)."""
    ones = torch.ones(edges.capacity, dtype=params.t.dtype,
                      device=params.t.device)
    r = edge_residuals(params, edges, ones, poses_per_robot)
    return torch.sum(r * r, dim=-1)


def init_from_odometry(edges: PoseGraphEdges, n_robots: int,
                       poses_per_robot: int) -> PgoParams:
    """Compose each robot's odometry chain from the identity (odometry
    edges join (robot, k) -> (robot, k+1); a missing step is the
    identity).

    The JAX package scatter-adds the odometry edges into per-robot step
    slots. At most one odometry edge lands in a slot, so an indexed
    assignment gives exactly the same steps (and is deterministic on the
    card, where a float scatter-add is not). The chain is composed by a
    loop over poses, batched over robots, in `lie.se3_compose`'s
    order: the card and the CPU compose the same bits, so PCM's
    threshold decisions on these poses (`pcm.py`) agree across
    devices."""
    n = n_robots * poses_per_robot
    dev, dt = edges.R.device, edges.R.dtype
    is_odo = edges.etype == EDGE_ODOMETRY
    slot = edges.src_robot.long() * poses_per_robot + edges.src_pose.long()
    slot = torch.where(is_odo, slot, n)  # the overflow bin
    R_steps = torch.eye(3, dtype=dt, device=dev).repeat(n + 1, 1, 1)
    t_steps = torch.zeros((n + 1, 3), dtype=dt, device=dev)
    # the non-odometry edges all land in the overflow bin, dropped below
    R_steps[slot] = torch.where(is_odo[:, None, None], edges.R,
                                R_steps[slot])
    t_steps[slot] = torch.where(is_odo[:, None], edges.t, t_steps[slot])
    R_steps = R_steps[:-1].reshape(n_robots, poses_per_robot, 3, 3)
    t_steps = t_steps[:-1].reshape(n_robots, poses_per_robot, 3)

    Rs, ts = [], []
    R_prev = torch.eye(3, dtype=dt, device=dev).expand(n_robots, 3, 3)
    t_prev = torch.zeros((n_robots, 3), dtype=dt, device=dev)
    for k in range(poses_per_robot):
        Rs.append(R_prev)
        ts.append(t_prev)
        R_prev, t_prev = lie.se3_compose(R_prev, t_prev,
                                         R_steps[:, k], t_steps[:, k])
    return PgoParams(R=torch.stack(Rs, dim=1).reshape(-1, 3, 3),
                     t=torch.stack(ts, dim=1).reshape(-1, 3))
