"""Deformation-graph mesh correction, the Kimera-PGMO step (the JAX
package's solve/deformation.py).

Embedded deformation (Sumner): graph nodes carry local rigid transforms
(R_g, t_g); the energy couples
  * regularization: neighbouring nodes must agree where they map each
    other's positions,
  * constraints: nodes attached to pose-graph keyframes must follow the
    optimized trajectory.
Rotations stay on SO(3) through the exp retraction R <- Exp(dw) R; the
Gauss-Newton system is solved matrix-free by CG.

The JAX package takes J through `jax.linearize` / `jax.vjp`. Here it is
written out. With u_e = R_s (p_d - p_s) for edge e = (s, d):
  regularizer row e: d/dw_s = -w_reg [u_e]_x, d/dt_s = w_reg I,
                     d/dt_d = -w_reg I (rows of invalid edges are 0);
  constraint row c:  d/dt_c = w_con I.

The system is ill-conditioned: its fixed 4 x 30 CG steps amplify
rounding (the positions of a 1,024-node odometry chain move by up to 1.2
m between a float32 and a float64 solve, `sim` world seed 0; two float64
implementations of the same steps part after ~10 CG steps on
tests/test_deformation.py's strip). So `solve` fixes the order of every
operation, and the card and the CPU give the same bits: J^T sums onto
the nodes along an incidence table (`solve/incidence.py`: slot 2e is
edge e's source, 2e + 1 its destination, 2E + c constraint c) by adding
its columns left to right; dot products add pairwise along a fixed tree;
products are elementwise in a fixed order (`lie.mat3_mul`, no matmul);
the retraction's sin and cos are power series (no library sin or cos,
which round differently on the two devices). It works in float64 and
returns the state in its input's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.backend import resolve_device
from ..frontend.lcd import _topk
from ..kernels.linalg import tree_sum
from .incidence import incidence_np


class DeformationGraph(NamedTuple):
    node_pos: torch.Tensor  # (G, 3) rest positions
    edge_src: torch.Tensor  # (E,) int32
    edge_dst: torch.Tensor  # (E,) int32
    edge_valid: torch.Tensor  # (E,) bool


class DeformationState(NamedTuple):
    R: torch.Tensor  # (G, 3, 3)
    t: torch.Tensor  # (G, 3)


class DeformationConfig(NamedTuple):
    w_reg: float = 1.0
    w_con: float = 10.0
    gn_iters: int = 8
    cg_iters: int = 40
    damping: float = 1e-5
    skin_k: int = 4


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, B) squared distances of rows of a (A, 3) and b (B, 3),
    ((dx^2 + dy^2) + dz^2)."""
    d = a[:, None] - b[None]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def build_graph_knn(node_pos: torch.Tensor, k: int = 4) -> DeformationGraph:
    """Connect each node to its k nearest neighbours (directed pairs: the
    regularizer is asymmetric, as Sumner's). Equal distances take the
    lower node index first (`jax.lax.top_k` order): odometry positions
    repeat where a robot stands still."""
    G = node_pos.shape[0]
    dev = node_pos.device
    d2 = _sq_dist(node_pos, node_pos)
    d2 = d2 + torch.eye(G, device=dev) * 1e12
    _, idx = _topk(-d2, k)
    src = torch.arange(G, device=dev).repeat_interleave(k)
    return DeformationGraph(
        node_pos=node_pos, edge_src=src.to(torch.int32),
        edge_dst=idx.reshape(-1).to(torch.int32),
        edge_valid=torch.ones(G * k, dtype=torch.bool, device=dev))


def identity_state(G: int, device="cuda") -> DeformationState:
    """Every node at the identity, on `device` (the card unless told
    otherwise)."""
    dev = resolve_device(device)
    return DeformationState(R=torch.eye(3, device=dev).expand(G, 3, 3),
                            t=torch.zeros((G, 3), device=dev))


def _edge_u(state: DeformationState, graph: DeformationGraph):
    s, d = graph.edge_src.long(), graph.edge_dst.long()
    g = graph.node_pos
    return lie.mat3_vec(state.R[s], g[d] - g[s]), s, d


def residuals(state: DeformationState, graph: DeformationGraph,
              con_node: torch.Tensor, con_target: torch.Tensor,
              con_valid: torch.Tensor,
              cfg: DeformationConfig) -> torch.Tensor:
    """Stacked residuals [r_reg (E, 3) | r_con (C, 3)], flattened."""
    u, s, d = _edge_u(state, graph)
    g = graph.node_pos
    # node s maps neighbour d's rest position; must agree with d's own
    mapped = u + g[s] + state.t[s]
    own = g[d] + state.t[d]
    r_reg = torch.where(graph.edge_valid[:, None],
                        (mapped - own) * cfg.w_reg, 0.0)
    c = con_node.long()
    moved = g[c] + state.t[c]
    r_con = torch.where(con_valid[:, None],
                        (moved - con_target) * cfg.w_con, 0.0)
    return torch.cat([r_reg.reshape(-1), r_con.reshape(-1)])


# Taylor coefficients of sin(x)/x and (1 - cos(x))/x^2 in x^2, highest
# first: 20 terms, within 1e-16 of them for |x| <= pi (float64)
_SIN_C = [(-1) ** k / float(np.prod(np.arange(1, 2 * k + 2, dtype=float)))
          for k in range(19, -1, -1)]
_COS_C = [(-1) ** k / float(np.prod(np.arange(1, 2 * k + 3, dtype=float)))
          for k in range(19, -1, -1)]


def _horner(coef, x2: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x2, coef[0])
    for c in coef[1:]:
        acc = acc * x2 + c
    return acc


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula I + a W + b W^2, a = sin(x)/x, b = (1 -
    cos(x))/x^2 with x = |w|, elementwise in a fixed order (the same bits
    on every device): below x = 1 as power series in x^2, above from sin
    and cos of x reduced to [-pi, pi], each a power series (CG steps on
    an ill-conditioned system reach x of 15)."""
    x2 = (w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]) \
        + w[..., 2] * w[..., 2]
    x = torch.sqrt(x2)
    r = x - (2 * np.pi) * torch.round(x / (2 * np.pi))
    r2 = r * r
    sin_r = r * _horner(_SIN_C, r2)
    cos_r = 1.0 - r2 * _horner(_COS_C, r2)
    big = x2 >= 1.0
    xs = torch.where(big, x, 1.0)
    a = torch.where(big, sin_r / xs, _horner(_SIN_C, x2))[..., None, None]
    b = torch.where(big, (1.0 - cos_r) / (xs * xs),
                    _horner(_COS_C, x2))[..., None, None]
    W = lie.hat(w)
    return (lie._eye_like(W) + a * W) + b * lie.mat3_mul(W, W)


def retract(state: DeformationState,
            delta: torch.Tensor) -> DeformationState:
    """delta (G, 6) = [dw | dt]: R <- Exp(dw) R, t <- t + dt."""
    return DeformationState(R=lie.mat3_mul(so3_exp(delta[:, :3]), state.R),
                            t=state.t + delta[:, 3:])


def _sum_onto_nodes(slots: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """Slot rows (S, 6) summed onto the nodes along the incidence table
    (1, G, D), its columns added left to right: (G, 6)."""
    padded = torch.cat([slots, slots.new_zeros((1, slots.shape[1]))])
    rows = padded[inc[0]]  # (G, D, 6)
    acc = rows[:, 0]
    for j in range(1, rows.shape[1]):
        acc = acc + rows[:, j]
    return acc


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b for (..., 3) rows, elementwise."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def _solve_incidence(graph: DeformationGraph, con_node: torch.Tensor,
                    con_valid: torch.Tensor) -> torch.Tensor:
    """(1, G, D) table of the slots that touch each node: 2e edge e's
    source, 2e + 1 its destination (valid edges only), 2E + c constraint
    c (valid constraints only). Built on the host, once per solve."""
    G = graph.node_pos.shape[0]
    idx = torch.cat([torch.stack([graph.edge_src, graph.edge_dst],
                                 1).reshape(-1), con_node.to(torch.int32)])
    ok = torch.cat([torch.stack([graph.edge_valid, graph.edge_valid],
                                1).reshape(-1), con_valid])
    idx = idx.cpu().numpy()[None]
    table = incidence_np(np.zeros_like(idx), idx, ok.cpu().numpy()[None],
                         [0], G)
    return torch.from_numpy(table).to(graph.node_pos.device)


@torch.no_grad()
def solve(state0: DeformationState, graph: DeformationGraph,
          con_node: torch.Tensor, con_target: torch.Tensor,
          con_valid: torch.Tensor,
          cfg: DeformationConfig = DeformationConfig()) -> DeformationState:
    """cfg.gn_iters Gauss-Newton steps, each with cfg.cg_iters CG steps on
    (J^T J + damping I) delta = -J^T r from delta = 0 (the JAX package's
    1e-20 guards), in float64; the state comes back in state0's dtype."""
    E = graph.edge_src.shape[0]
    inc = _solve_incidence(graph, con_node, con_valid)
    out_dtype = state0.t.dtype
    f64 = torch.float64
    graph = graph._replace(node_pos=graph.node_pos.to(f64))
    con_target = con_target.to(f64)
    state0 = DeformationState(R=state0.R.to(f64), t=state0.t.to(f64))
    s, d = graph.edge_src.long(), graph.edge_dst.long()
    c = con_node.long()
    ev = graph.edge_valid[:, None]
    cv = con_valid[:, None]
    w_reg, w_con = cfg.w_reg, cfg.w_con

    def jt(u, y_reg, y_con):
        """J^T y for rows y_reg (E, 3), y_con (C, 3): (G, 6)."""
        zero = torch.zeros_like(y_reg)
        src = torch.cat([_cross(u, y_reg) * w_reg, y_reg * w_reg], -1)
        dst = torch.cat([zero, y_reg * -w_reg], -1)
        con = torch.cat([torch.zeros_like(y_con), y_con * w_con], -1)
        slots = torch.cat([torch.stack([src, dst], 1).reshape(-1, 6), con])
        return _sum_onto_nodes(slots, inc)

    def jv(u, v):
        """J v for v (G, 6): rows (E, 3), (C, 3)."""
        dw_s, dt_s, dt_d = v[s, :3], v[s, 3:], v[d, 3:]
        # -[u]_x dw = dw x u
        j_reg = torch.where(ev, (_cross(dw_s, u) + dt_s - dt_d) * w_reg, 0.0)
        j_con = torch.where(cv, v[c, 3:] * w_con, 0.0)
        return j_reg, j_con

    state = state0
    for _ in range(cfg.gn_iters):
        u, _, _ = _edge_u(state, graph)
        r = residuals(state, graph, con_node, con_target, con_valid, cfg)
        gvec = jt(u, r[:3 * E].reshape(E, 3), r[3 * E:].reshape(-1, 3))

        def mv(v, u=u):
            return jt(u, *jv(u, v)) + cfg.damping * v

        x = torch.zeros_like(gvec)
        rr = -gvec
        p = -gvec
        rs = tree_sum((gvec * gvec).reshape(-1))
        for _ in range(cfg.cg_iters):
            Ap = mv(p)
            al = rs / torch.clamp(tree_sum((p * Ap).reshape(-1)), min=1e-20)
            x = x + al * p
            rr = rr - al * Ap
            rs2 = tree_sum((rr * rr).reshape(-1))
            p = p * (rs2 / torch.clamp(rs, min=1e-20)) + rr
            rs = rs2
        state = retract(state, x)
    return DeformationState(R=state.R.to(out_dtype), t=state.t.to(out_dtype))


def skinning(vertices: torch.Tensor, node_pos: torch.Tensor, k: int = 4):
    """k-NN skinning weights: (V, k) node indices and normalized weights
    w ~ (1 - d / d_max)^2 (Sumner's falloff), d_max the (k+1)-th nearest
    distance. Equal distances take the lower node index first."""
    d2 = _sq_dist(vertices, node_pos)
    neg, idx = _topk(-d2, k + 1)
    dist = torch.sqrt(torch.clamp(-neg, min=0.0))
    dmax = dist[:, -1:]
    w = torch.clamp(1.0 - dist[:, :k] / torch.clamp(dmax, min=1e-9),
                    min=0.0) ** 2
    w = w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-12)
    return idx[:, :k].to(torch.int32), w


def deform_vertices(vertices: torch.Tensor, graph: DeformationGraph,
                    state: DeformationState, skin_idx: torch.Tensor,
                    skin_w: torch.Tensor) -> torch.Tensor:
    """Re-skin mesh vertices (V, 3) through the deformation graph (gather,
    then a weighted blend)."""
    si = skin_idx.long()
    g = graph.node_pos[si]  # (V, k, 3)
    moved = lie.mat3_vec(state.R[si], vertices[:, None, :] - g) + g \
        + state.t[si]
    return torch.sum(moved * skin_w[..., None], dim=1)
