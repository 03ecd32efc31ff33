"""The port's robust back-end against the JAX package's on the CPU:
`robust.robust_pgo` (PCM, then Gauss-Newton under GNC-TLS) on
tests/test_chordal_pcm.py's graph (`multi_robot_graph(seed=11,
n_robots=3, n_poses=32, outlier_ratio=0.4, ...)`) at
gnc_outer_iters=2, gn_iters=2, cg_iters=10, and `chordal.chordal_init` on
its clean graph (seed 7, 2 x 24, 150 CG steps), carried across as numpy;
and the written-out Gauss-Newton Jacobian of `pgo.py` against
`torch.func` of the residual function, in float64.

Tolerances: GNC weights within 1e-5 and mu within 1e-6 relative; poses
after robust_pgo within 2e-5 absolute (the 2 x 10 CG steps of
tests/test_torch_pgo.py's Gauss-Newton bound, on poses up to 10 m);
chordal rotations within 1e-5 and translations within 5e-5 (150 float32
CG steps on a linear system, summed in other orders); the written-out J v
and J^T u within 1e-9 relative of autodiff in float64 (the Jacobians are
the same functions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.io.synthetic import multi_robot_graph as jgraph
from kimera_multi_tpu.solve import chordal as jchordal, pgo as jpgo
from kimera_multi_tpu.solve import robust as jrobust
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.eval.ape import align_left
from kimera_multi_tpu_torch.solve import chordal, incidence, pgo, robust

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")


def _edges(gj, device="cpu"):
    return convert.edges_from_numpy(
        **{f: np.asarray(getattr(gj.edges, f)) for f in FIELDS},
        device=device)


@pytest.fixture(scope="module")
def pcm_graph():
    return jgraph(seed=11, n_robots=3, n_poses=32, outlier_ratio=0.4,
                  n_intra_lc=4, n_inter_lc=8)


def test_robust_pgo_matches_jax(pcm_graph):
    gj = pcm_graph
    edges = _edges(gj)
    pj0 = jpgo.init_from_odometry(gj.edges, 3, 32)
    p0 = convert.pgo_params_from_numpy(np.asarray(pj0.R), np.asarray(pj0.t),
                                       device="cpu")
    kw = dict(gnc_outer_iters=2, gn_iters=2, cg_iters=10)
    pj, sj = jrobust.robust_pgo(pj0, gj.edges, 32, **kw)
    info = {}
    p, s = robust.robust_pgo(p0, edges, 32, info=info, **kw)
    np.testing.assert_allclose(s.weights.numpy(), np.asarray(sj.weights),
                               rtol=0, atol=1e-5)
    assert abs(float(s.mu) - float(sj.mu)) <= 1e-6 * float(sj.mu)
    assert int(s.outer_iter) == int(sj.outer_iter) == 2
    np.testing.assert_allclose(p.R.numpy(), np.asarray(pj.R), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(pj.t), rtol=0,
                               atol=2e-5)
    assert info["consensus"].shape == (edges.capacity,)
    assert info["frame_ok"].tolist() == [True, True, True]
    assert 0 < info["pcm_s"] <= info["robust_pgo_s"]


def test_chordal_init_matches_jax():
    gj = jgraph(seed=7, n_robots=2, n_poses=24, outlier_ratio=0.0,
                rot_noise=0.001, trans_noise=0.002)
    edges = _edges(gj)
    pj = jchordal.chordal_init(gj.edges, jnp.ones(gj.edges.capacity), 48,
                               24, cg_iters=150)
    p = chordal.chordal_init(edges, torch.ones(edges.capacity), 48, 24,
                             cg_iters=150)
    np.testing.assert_allclose(p.R.numpy(), np.asarray(pj.R), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(pj.t), rtol=0,
                               atol=5e-5)
    # tests/test_chordal_pcm.py's bound on the port's result
    R_gt = torch.from_numpy(np.asarray(gj.R_gt))
    t_gt = torch.from_numpy(np.asarray(gj.t_gt))
    _, ta = align_left(R_gt[0], t_gt[0], p.R[0], p.t[0], p.R, p.t)
    assert float(torch.linalg.vector_norm(ta - t_gt, dim=-1).max()) < 0.2


def test_written_out_jacobian_equals_autodiff(pcm_graph):
    """J v and J^T u of `pgo._linearize` (edges and anchor) against
    torch.func.jvp / vjp of the residual of the retraction's increment,
    in float64, at perturbed poses (residual angles up to 3 rad) under
    uneven weights."""
    import dataclasses

    from kimera_multi_tpu_torch.core import lie

    gj = pcm_graph
    e = _edges(gj)
    e = dataclasses.replace(e, **{f: getattr(e, f).double()
                                  for f in ("R", "t", "kappa", "tau")})
    # rotations in float64 (float32's are orthonormal to 1e-7 only, and
    # the written-out Jacobian is that of the log of a rotation)
    e = dataclasses.replace(e, R=lie.so3_project(e.R))
    N, E = 96, e.capacity
    p0 = pgo.init_from_odometry(e, 3, 32)
    rs = np.random.default_rng(3)
    p0 = pgo.retract(p0, torch.from_numpy(0.3 * rs.normal(size=(N, 6))))
    w = torch.from_numpy(rs.uniform(0.2, 1.0, E))
    src, dst = e.global_ids(32)
    ww = torch.where(e.valid, w, 0.0)
    s_rot = torch.sqrt(ww * e.kappa)
    s_tr = torch.sqrt(ww * e.tau)
    r_e, J_e, r_a, J_a = pgo._linearize(p0, e, src, dst, s_rot, s_tr,
                                        100.0)

    def f(d):
        p = pgo.retract(p0, d)
        return torch.cat([pgo.edge_residuals(p, e, w, 32).reshape(-1),
                          pgo.anchor_residual(p, 1e4)])

    d0 = torch.zeros((N, 6), dtype=torch.float64)
    r0, vjp_fn = torch.func.vjp(f, d0)
    assert torch.allclose(r_e.reshape(-1), r0[:-6], rtol=1e-12, atol=1e-12)
    assert torch.allclose(r_a, r0[-6:], rtol=1e-12, atol=1e-12)
    v = torch.from_numpy(rs.normal(size=(N, 6)))
    ids2 = torch.stack([src, dst], dim=1).reshape(-1)
    Jv = (J_e @ v[ids2].reshape(E, 12, 1))[..., 0]
    Jv_ref = torch.func.jvp(f, (d0,), (v,))[1]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(Jv.reshape(-1), Jv_ref[:-6]) < 1e-9
    inc = incidence.edge_incidence(e, 32, N)
    u = torch.from_numpy(rs.normal(size=(E * 6 + 6,)))
    Jtu = pgo._apply_jt(J_e, u[:-6].reshape(E, 6), inc, N)
    Jtu[0] += J_a.T @ u[-6:]
    assert rel(Jtu, vjp_fn(u)[0]) < 1e-9


def test_edge_incidence_lists_each_slot_once(pcm_graph):
    e = _edges(pcm_graph)
    inc = incidence.edge_incidence(e, 32, 96)
    E = e.capacity
    slots = inc[0][inc[0] < 2 * E]
    src, dst = e.global_ids(32)
    valid = e.valid
    want = torch.nonzero(torch.stack([valid, valid], 1).reshape(-1))[:, 0]
    assert torch.equal(torch.sort(slots).values, want)
    ids2 = torch.stack([src, dst], 1).reshape(-1)
    for p in (0, 5, 40, 95):  # each row lists its pose's slots in order
        row = inc[0, p][inc[0, p] < 2 * E]
        assert torch.equal(row, want[ids2[want] == p])
    # the sum onto poses equals a float64 scatter-add
    contrib = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2 * E, 6)))
    ref = torch.zeros((96, 6), dtype=torch.float64)
    ref.index_add_(0, ids2[want], contrib[0, want])
    got = incidence.reduce_onto_poses(contrib, inc, 96)[0]
    assert torch.allclose(got, ref, rtol=1e-12, atol=1e-12)
