"""Single-block SE(3) pose-graph optimization: matrix-free Gauss-Newton
(the JAX package's solve/pgo.py).

Residuals over all edges are one batched gather and Lie operations; the
normal system is never formed: CG applies J and J^T through
`torch.func.jvp` / `torch.func.vjp` of the residual function (this
module is not on the RBCD path, which is written out analytically). Fixed
iteration counts, no value read back to the host. The gauge is fixed by a
prior on pose 0; padding poses have no factors and keep their values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.containers import EDGE_ODOMETRY, PoseGraphEdges


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


def gauss_newton(params0: PgoParams, edges: PoseGraphEdges,
                 edge_weights: torch.Tensor, poses_per_robot: int,
                 gn_iters: int = 20, cg_iters: int = 50,
                 damping: float = 1e-4,
                 anchor_weight: float = 1e4) -> PgoParams:
    """Damped Gauss-Newton with matrix-free CG inner solves."""
    N = params0.R.shape[0]

    def full_residual(delta, params):
        p = retract(params, delta)
        r_e = edge_residuals(p, edges, edge_weights, poses_per_robot)
        r_a = anchor_residual(p, anchor_weight)
        return torch.cat([r_e.reshape(-1), r_a])

    params = params0
    for _ in range(gn_iters):
        delta0 = torch.zeros((N, 6), dtype=params.t.dtype,
                             device=params.t.device)
        f = lambda d, p=params: full_residual(d, p)
        r0, vjp_fn = torch.func.vjp(f, delta0)

        def matvec(v, f=f, vjp_fn=vjp_fn, delta0=delta0):
            Jv = torch.func.jvp(f, (delta0,), (v,))[1]
            return vjp_fn(Jv)[0] + damping * v

        g = vjp_fn(r0)[0]  # J^T r
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
    loop over poses, batched over robots."""
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
        R_prev, t_prev = lie.se3_compose(R_prev, t_prev, R_steps[:, k],
                                         t_steps[:, k])
    return PgoParams(R=torch.stack(Rs, dim=1).reshape(-1, 3, 3),
                     t=torch.stack(ts, dim=1).reshape(-1, 3))
