"""The port's pose-graph layer against the JAX package's, on the CPU:
`io.synthetic.multi_robot_graph` (the same numpy draws, so the same
graph), `convert.edges_from_numpy`, `concat_edges`,
`pgo.init_from_odometry`, `edge_residuals`, `pgo_cost`,
`edge_squared_errors` and two iterations of `gauss_newton`, on the graphs
of tests/test_solve_pgo.py.

Tolerances: the graph and the odometry steps are equal; the composed
odometry chain within 2e-5 (16 - 32 float32 compositions, rotations near
1 and translations near 10 in magnitude); residuals within 2e-4
absolute (the translation residual of a pose 10 m from the origin,
times sqrt(tau) = 10); Gauss-Newton's poses within 2e-5 after two
iterations of 10 CG steps on the outlier graph under uneven weights (J and
J^T come from torch.func on one side and jax.linearize / jax.vjp on the
other, summed in other orders; over 40 CG steps float32 CG loses
conjugacy and each package's rounding takes it elsewhere, ROADMAP
Queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import containers as jc
from kimera_multi_tpu.io.synthetic import multi_robot_graph as jgraph
from kimera_multi_tpu.solve import pgo as jpgo
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import containers as tc
from kimera_multi_tpu_torch.io import synthetic
from kimera_multi_tpu_torch.solve import pgo

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")
GRAPHS = {  # tests/test_solve_pgo.py's graphs
    "chain": dict(seed=1, n_robots=2, n_poses=16, outlier_ratio=0.0,
                  rot_noise=0.0, trans_noise=0.0),
    "clean": dict(seed=2, n_robots=1, n_poses=32, outlier_ratio=0.0,
                  rot_noise=0.002, trans_noise=0.005),
    "outliers": dict(seed=3, n_robots=2, n_poses=48, outlier_ratio=0.35,
                     n_intra_lc=6, n_inter_lc=10),
}


def _edges_np(e):
    return {f: np.asarray(getattr(e, f)) for f in FIELDS}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_and_odometry_init_match_jax(name):
    kw = GRAPHS[name]
    gj = jgraph(**kw)
    g = synthetic.multi_robot_graph(**kw, device="cpu")
    ej = _edges_np(gj.edges)
    for f in FIELDS:
        assert np.array_equal(getattr(g.edges, f).numpy(), ej[f]), f
    for f in ("R_gt", "t_gt", "is_outlier"):
        assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(gj, f)))
    assert g.edges.capacity == gj.edges.capacity
    assert np.array_equal(g.edges.valid.numpy(), np.asarray(gj.edges.valid))
    # the numpy form carries the same fields
    gn = synthetic.multi_robot_graph_np(**kw)
    assert all(np.array_equal(gn[f], ej[f]) for f in FIELDS)
    n_robots, ppr = kw["n_robots"], kw["n_poses"]
    pj = jpgo.init_from_odometry(gj.edges, n_robots, ppr)
    p = pgo.init_from_odometry(g.edges, n_robots, ppr)
    np.testing.assert_allclose(p.R.numpy(), np.asarray(pj.R), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(pj.t), rtol=0,
                               atol=2e-5)
    if name == "chain":  # noiseless odometry: the ground truth up to gauge
        for r in range(n_robots):
            sl = slice(r * ppr, (r + 1) * ppr)
            est = p.R[sl][:1].transpose(-1, -2) @ p.R[sl]
            gt = g.R_gt[sl][:1].transpose(-1, -2) @ g.R_gt[sl]
            np.testing.assert_allclose(est.numpy(), gt.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def outlier_graph():
    """The outlier graph in both packages, with one weight vector and
    perturbed odometry-initialized poses."""
    kw = GRAPHS["outliers"]
    gj = jgraph(**kw)
    edges = convert.edges_from_numpy(**_edges_np(gj.edges), device="cpu")
    n_robots, ppr = kw["n_robots"], kw["n_poses"]
    pj = jpgo.init_from_odometry(gj.edges, n_robots, ppr)
    npr = np.random.default_rng(0)
    w = npr.uniform(0.2, 1.0, gj.edges.capacity).astype(np.float32)
    delta = (0.05 * npr.normal(size=(n_robots * ppr, 6))).astype(np.float32)
    pj = jpgo.retract(pj, jnp.asarray(delta))
    p = convert.pgo_params_from_numpy(np.asarray(pj.R), np.asarray(pj.t),
                                      device="cpu")
    return gj, edges, pj, p, w, ppr


def test_edge_residuals_and_costs_match_jax(outlier_graph):
    gj, edges, pj, p, w, ppr = outlier_graph
    rj = np.asarray(jpgo.edge_residuals(pj, gj.edges, jnp.asarray(w), ppr))
    rt = pgo.edge_residuals(p, edges, torch.from_numpy(w), ppr).numpy()
    assert rt.shape == rj.shape == (edges.capacity, 6)
    np.testing.assert_allclose(rt, rj, rtol=0, atol=2e-4)
    assert not rt[~edges.valid.numpy()].any()  # padding rows are zeros
    cj = float(jpgo.pgo_cost(pj, gj.edges, jnp.asarray(w), ppr))
    ct = float(pgo.pgo_cost(p, edges, torch.from_numpy(w), ppr))
    assert abs(ct - cj) <= 1e-5 * cj
    sj = np.asarray(jpgo.edge_squared_errors(pj, gj.edges, ppr))
    st = pgo.edge_squared_errors(p, edges, ppr).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-4, atol=1e-4)
    aj = np.asarray(jpgo.anchor_residual(pj, 1e4))
    np.testing.assert_allclose(pgo.anchor_residual(p, 1e4).numpy(), aj,
                               rtol=0, atol=1e-4)


def test_gauss_newton_two_iterations_match_jax(outlier_graph):
    gj, edges, pj0, p0, w, ppr = outlier_graph
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    pj = jpgo.gauss_newton(pj0, gj.edges, wj, ppr, gn_iters=2, cg_iters=10)
    p = pgo.gauss_newton(p0, edges, wt, ppr, gn_iters=2, cg_iters=10)
    np.testing.assert_allclose(p.R.numpy(), np.asarray(pj.R), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(pj.t), rtol=0,
                               atol=2e-5)
    c0 = float(pgo.pgo_cost(p0, edges, wt, ppr))
    c2 = float(pgo.pgo_cost(p, edges, wt, ppr))
    cj = float(jpgo.pgo_cost(pj, gj.edges, wj, ppr))
    assert c2 < 0.5 * c0 and abs(c2 - cj) <= 1e-5 * cj


def test_containers_and_concat_edges_match_jax():
    gj = jgraph(**GRAPHS["outliers"])
    ej = _edges_np(gj.edges)
    edges = convert.edges_from_numpy(**ej, device="cpu")
    half = edges.capacity // 2
    parts = [tc.PoseGraphEdges(**{f: getattr(edges, f)[sl] for f in FIELDS})
             for sl in (slice(0, half), slice(half, None))]
    jparts = [jc.PoseGraphEdges(**{f: jnp.asarray(ej[f][sl])
                                   for f in FIELDS})
              for sl in (slice(0, half), slice(half, None))]
    for cap in (None, 256):
        got = tc.concat_edges(parts[::-1], capacity=cap)
        want = jc.concat_edges(jparts[::-1], capacity=cap)
        assert got.capacity == want.capacity
        for f in FIELDS:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f))), f
    with pytest.raises(ValueError):
        tc.concat_edges(parts, capacity=8)
    empty = tc.PoseGraphEdges.empty(16)
    assert empty.capacity == 16 and not empty.valid.any()
    assert torch.equal(empty.R, torch.eye(3).expand(16, 3, 3))
    src, dst = edges.global_ids(48)
    sj, dj = gj.edges.global_ids(48)
    assert np.array_equal(src.numpy(), np.asarray(sj))
    assert np.array_equal(dst.numpy(), np.asarray(dj))


def test_graph_defaults_to_the_card():
    """The generator's tensors go to the card unless the CPU is asked
    for; without a card, the default raises before any work is done."""
    if torch.cuda.is_available():
        g = synthetic.multi_robot_graph(seed=0, n_robots=2, n_poses=8)
        assert g.edges.R.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.multi_robot_graph(seed=0, n_robots=2, n_poses=8)
