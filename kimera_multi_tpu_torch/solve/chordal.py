"""Chordal initialization: linear rotation averaging, then translation
recovery (the JAX package's solve/chordal.py).

Both subproblems are linear least squares over the pose graph,

  rotations:    min sum_e w_e kappa_e || X_j - X_i R_ij ||_F^2,  X in R^3x3
  translations: min sum_e w_e tau_e || (t_j - t_i) - R_i t_ij ||^2,

each with a prior anchoring pose 0, solved matrix-free by CG; rotations
are then projected onto SO(3). The residuals are linear, so J and J^T are
written out (the JAX package takes them from `jax.linearize` /
`jax.vjp`): J v is a gather and a product per edge, J^T u a sum onto the
poses along the graph's incidence table (`incidence.edge_incidence`), so
two card runs give the same bits.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..core.containers import PoseGraphEdges
from .incidence import edge_incidence, reduce_onto_poses
from .pgo import PgoParams, _cg


def chordal_init(edges: PoseGraphEdges, edge_weights: torch.Tensor,
                 n_poses_total: int, poses_per_robot: int | None = None,
                 cg_iters: int = 100,
                 anchor_weight: float = 1e3) -> PgoParams:
    """Returns PgoParams with pose 0 anchored at the identity."""
    ppr = poses_per_robot if poses_per_robot is not None else n_poses_total
    N = n_poses_total
    src, dst = edges.global_ids(ppr)
    ids2 = torch.stack([src, dst], dim=1).reshape(-1)
    inc = edge_incidence(edges, ppr, N)
    E = edges.capacity
    w = torch.where(edges.valid, edge_weights, 0.0)
    s_rot = torch.sqrt(torch.clamp(w * edges.kappa, min=0.0))[:, None, None]
    s_tr = torch.sqrt(torch.clamp(w * edges.tau, min=0.0))[:, None]
    sa2 = float(anchor_weight)  # the anchor's J^T J, sqrt(w)^2
    dev, dt = edges.R.device, edges.R.dtype
    eye = torch.eye(3, dtype=dt, device=dev)
    RT = edges.R.transpose(-1, -2)

    def onto_poses(u_src, u_dst):
        """Sum per-edge terms at the source and destination slots."""
        g = torch.stack([u_src, u_dst], dim=1).reshape(1, 2 * E,
                                                       *u_src.shape[1:])
        return reduce_onto_poses(g, inc, N)[0]

    # ---- rotations: residual (X_j - X_i R_ij) s_rot, anchor (X_0 - I) sa
    def rot_jt(u):  # u (E, 3, 3) edge residual rows -> (N, 3, 3)
        return onto_poses(-(u * s_rot) @ RT, u * s_rot)

    def rot_matvec(V):
        Vs, Vd = V[ids2].reshape(E, 2, 3, 3).unbind(1)
        out = rot_jt((Vd - Vs @ edges.R) * s_rot)
        out[0] += sa2 * V[0]
        return out + 1e-6 * V

    X0 = eye.expand(N, 3, 3)
    # J^T r at X0 (the anchor's residual is zero there)
    g = rot_jt((eye - edges.R) * s_rot)
    R = lie.so3_project(X0 + _cg(rot_matvec, -g, cg_iters))

    # ---- translations: residual ((t_j - t_i) - R_i t_ij) s_tr, anchor
    # t_0 sa
    Rt_src = torch.einsum("eij,ej->ei", R[src], edges.t)

    def tr_jt(u):  # u (E, 3) -> (N, 3)
        return onto_poses(-(u * s_tr), u * s_tr)

    def tr_matvec(v):
        vs, vd = v[ids2].reshape(E, 2, 3).unbind(1)
        out = tr_jt((vd - vs) * s_tr)
        out[0] += sa2 * v[0]
        return out + 1e-6 * v

    # J^T r at t = 0 (the anchor's residual is zero there)
    gt = tr_jt(-Rt_src * s_tr)
    t = _cg(tr_matvec, -gt, cg_iters)
    return PgoParams(R=R, t=t)
