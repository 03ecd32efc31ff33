"""Sequence parallelism: pose-chain sharding with halo exchange (the JAX
package's dist/chain.py).

When one robot's trajectory outgrows a device, its pose chain is split
into contiguous blocks over the ranks of a group. Chain (odometry)
coupling is local: each CG iteration exchanges only the boundary poses
with the ring neighbours (the halo). Loop-closure coupling is sparse:
endpoint values are combined with one small all_reduce over a
fixed-capacity endpoint table. Per-iteration communication is O(1) +
O(E_lc), not O(N).

The halo is one all_gather of every rank's first and last rows, from
which each rank takes its neighbours' (the JAX package's two `ppermute`s
over the ring). torch.distributed refuses a send from a rank to itself,
and on a ring of one rank each neighbour is the rank itself; the gather
serves every group size with the same collective. Sums onto the owned
poses go along an incidence table (solve/incidence.py), not a scatter,
so two runs on the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solve.incidence import incidence_np, reduce_onto_poses
from .mesh import RobotGroup


def make_chain_translation_solver(group: RobotGroup, n_poses: int,
                                  lc_capacity: int, cg_iters: int = 100,
                                  anchor_weight: float = 1e3):
    """A chain-sharded solver for

        min_t  sum_chain wc_i ||t_{i+1} - t_i - d_i||^2
             + sum_lc w_e ||t_{dst_e} - t_{src_e} - d_e||^2
             + anchor ||t_0||^2

    d_chain: (n_poses, 3) chain deltas (row i = measured t_{i+1} - t_i,
    last row ignored); lc_src / lc_dst: (lc_capacity,) int32 (-1
    padding); lc_d: (lc_capacity, 3); lc_w: (lc_capacity,). Every rank
    passes the whole arrays and solves its contiguous block of
    n_poses / W poses; returns the whole t (n_poses, 3), gathered.

    Per-chain-edge weights wc (row i = weight of edge i -> i + 1) let one
    solve cover a CONCATENATED fleet chain: robot boundaries get wc = 0,
    inter-robot coupling rides the LC table (cli/run.py --chain-refine)."""
    S = group.world
    if n_poses % S:
        raise ValueError(f"{S} ranks do not divide {n_poses} poses")
    n_local = n_poses // S
    s = group.rank
    base = s * n_local

    def solve(d_chain, lc_src, lc_dst, lc_d, lc_w, w_chain=None, x0=None):
        dev, dt = d_chain.device, d_chain.dtype
        if w_chain is None:
            w_chain = torch.ones((n_poses,), dtype=dt, device=dev)
        if x0 is None:
            x0 = torch.zeros((n_poses, 3), dtype=dt, device=dev)
        sl = slice(base, base + n_local)
        d_loc, wc_loc, x0_loc = d_chain[sl], w_chain[sl], x0[sl]
        gidx = base + torch.arange(n_local, device=dev)
        lc_valid = lc_src >= 0
        w = torch.where(lc_valid, lc_w, 0.0)

        def own_of(ids):
            own = (ids >= base) & (ids < base + n_local) & lc_valid
            return own, torch.clamp(ids - base, 0, n_local - 1).long()

        own_src, loc_src = own_of(lc_src)
        own_dst, loc_dst = own_of(lc_dst)
        # the LC slots on each owned pose, in slot order (host, once)
        def table(own, loc):
            o = own.cpu().numpy()[None]
            return torch.from_numpy(incidence_np(
                np.zeros_like(o, np.int64), loc.cpu().numpy()[None], o,
                [0], n_local)).to(dev)

        inc_src, inc_dst = table(own_src, loc_src), table(own_dst, loc_dst)

        def onto_own(inc, vals):
            """Sum (lc_capacity, 3) values onto the owned poses."""
            return reduce_onto_poses(vals[None], inc, n_local)[0]

        def halo(v_loc):
            """The row just left of this block (the left neighbour's last)
            and just right of it (the right neighbour's first)."""
            g = group.all_gather(torch.stack([v_loc[0], v_loc[-1]]))
            return g[2 * ((s - 1) % S) + 1], g[2 * ((s + 1) % S)]

        def lc_values(v_loc):
            """Every LC endpoint's value, assembled with one all_reduce:
            each rank contributes the endpoints it owns."""
            pick = lambda own, loc: torch.where(own[:, None], v_loc[loc],
                                                0.0)
            both = group.all_reduce(torch.stack([pick(own_src, loc_src),
                                                 pick(own_dst, loc_dst)]))
            return both[0], both[1]

        # weight of the chain edge LEFT of pose i (edge i - 1 -> i) needs
        # the neighbour's last weight, exchanged once outside the CG loop
        wc_left = group.all_gather(wc_loc[-1:])[(s - 1) % S]
        wcm1 = torch.cat([wc_left[None], wc_loc[:-1]])
        wl = torch.where(gidx > 0, wcm1, 0.0)  # edge into pose i
        wr = torch.where(gidx < n_poses - 1, wc_loc, 0.0)  # edge out

        def matvec(v_loc):
            """Normal-equation matvec: weighted chain Laplacian + LC terms
            + anchor."""
            left, right = halo(v_loc)
            vm1 = torch.cat([left[None], v_loc[:-1]])
            vp1 = torch.cat([v_loc[1:], right[None]])
            out = ((wl + wr)[:, None] * v_loc - wl[:, None] * vm1
                   - wr[:, None] * vp1)
            src_v, dst_v = lc_values(v_loc)
            diff = (dst_v - src_v) * w[:, None]
            out = out + onto_own(inc_dst, diff) - onto_own(inc_src, diff)
            return out + torch.where((gidx == 0)[:, None],
                                     anchor_weight * v_loc, 0.0)

        def dot(a, b):
            return group.all_reduce(torch.sum(a * b))

        # right-hand side b = A^T d
        dm1 = torch.cat([halo(d_loc)[0][None], d_loc[:-1]])
        b = wl[:, None] * dm1 - wr[:, None] * d_loc
        lcd = lc_d * w[:, None]
        b = b + onto_own(inc_dst, lcd) - onto_own(inc_src, lcd)

        # CG from the warm start: CG never moves components whose residual
        # is zero, so a block disconnected from the anchor keeps its
        # initial placement instead of collapsing to the min-norm one
        x = x0_loc
        r = b - matvec(x)
        p, rs = r, dot(r, r)
        for _ in range(cg_iters):
            Ap = matvec(p)
            alpha = rs / torch.clamp(dot(p, Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rs2 = dot(r, r)
            p = r + rs2 / torch.clamp(rs, min=1e-20) * p
            rs = rs2
        return group.all_gather(x)

    return solve


def chain_translation_reference(n_poses, d_chain, lc_src, lc_dst, lc_d,
                                lc_w, anchor_weight=1e3, w_chain=None):
    """Dense single-process least-squares solution (numpy, for tests)."""
    if w_chain is None:
        w_chain = np.ones(n_poses)
    A_rows, b_rows = [], []
    for i in range(n_poses - 1):
        sw = np.sqrt(w_chain[i])
        row = np.zeros(n_poses)
        row[i + 1], row[i] = sw, -sw
        A_rows.append(row)
        b_rows.append(np.asarray(d_chain[i]) * sw)
    for e in range(len(lc_src)):
        if lc_src[e] < 0:
            continue
        row = np.zeros(n_poses)
        row[lc_dst[e]], row[lc_src[e]] = 1, -1
        A_rows.append(row * np.sqrt(lc_w[e]))
        b_rows.append(np.asarray(lc_d[e]) * np.sqrt(lc_w[e]))
    row = np.zeros(n_poses)
    row[0] = np.sqrt(anchor_weight)
    A_rows.append(row)
    b_rows.append(np.zeros(3))
    return np.linalg.lstsq(np.stack(A_rows), np.stack(b_rows),
                           rcond=None)[0]
