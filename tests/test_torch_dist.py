"""The port's distribution tier (kimera_multi_tpu_torch/dist/) on the CPU,
against the JAX package's dist/ on conftest's virtual CPU devices.

Several ranks are spawned processes joined into a gloo group through a
FileStore (tests/_torch_ranks.py); one rank is a group inside the test
process. Graphs and lifted starts come from the JAX package
(tests/test_rbcd_dist.py's `_setup`: 2 robots x 24 poses and its
variants) and cross as numpy.

Tolerances: a round against the JAX package's `make_round_fn` on a
2-device mesh within 1e-5 (tests/test_rbcd_dist.py's); 2 ranks against 1
rank within 1e-6 (on the CPU the two are bit-identical, asserted as
well); the one-rank round equal to `rbcd_round_reference` with GNC bit
for bit; a deactivated robot's block unchanged bit for bit; the chain
solve within 1e-3 of the dense least-squares solution and of the JAX
solver; the split hypothesis table equal to the unsplit `ransac_arun`
bit for bit, its inlier count equal to the JAX package's, R and t within
1e-5 of it.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import lie as jlie, rng as jrng, stiefel as jstiefel
from kimera_multi_tpu.dist import (chain as jchain, checkpoint as jckpt,
                                   mesh as jmesh, rounds as jrounds,
                                   sharded_verify as jsv)
from kimera_multi_tpu.io.synthetic import multi_robot_graph as jgraph
from kimera_multi_tpu.solve import pgo as jpgo, rbcd as jrbcd
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.dist import (chain, checkpoint, fault, mesh,
                                         rounds, sharded_verify)
from kimera_multi_tpu_torch.kernels import ransac
from kimera_multi_tpu_torch.solve import gnc, rbcd

import _jax_rounds as jax_rounds
import _torch_ranks as ranks

torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")


def _setup(seed=5, n_robots=2, n_poses=24, outlier_ratio=0.0):
    """tests/test_rbcd_dist.py's graph and lifted start (JAX)."""
    g = jgraph(seed=seed, n_robots=n_robots, n_poses=n_poses,
               outlier_ratio=outlier_ratio, n_intra_lc=4, n_inter_lc=6)
    p0 = jpgo.init_from_odometry(g.edges, g.n_robots, g.poses_per_robot)
    key = jrng.derive(jrng.base_key(0), jrng.Stream.LIFTING)
    Y0 = jrbcd.lift_params(p0, jstiefel.random_lifting_matrix(key, 5, 3),
                           g.n_robots, g.poses_per_robot)
    return g, Y0


def _data(g, Y0, **kw):
    return dict(edges={f: np.asarray(getattr(g.edges, f)) for f in FIELDS},
                Y0=np.asarray(Y0), ppr=g.poses_per_robot, **kw)


def _jax_rounds(g, Y0, cfg, n, **kw):
    m = jmesh.robot_mesh(g.n_robots)
    fn = jrounds.make_round_fn(m, g.edges, g.poses_per_robot, cfg, **kw)
    state = jrounds.init_state(m, Y0, jnp.ones(g.n_robots, bool), g.edges,
                               g.poses_per_robot)
    for _ in range(n):
        state, _ = fn(state)
    return m, fn, state


def _one_rank(data, n_rounds, gnc_every=1000, burnin=6, cfg=None):
    """`make_round_fn` on a one-rank group in this process."""
    edges = ranks.edges_of(data["edges"])
    Y0 = torch.from_numpy(data["Y0"])
    with mesh.robot_group(Y0.shape[0], "cpu") as group:
        fn = rounds.make_round_fn(group, edges, data["ppr"],
                                  cfg or rbcd.RbcdConfig(inner_iters=3),
                                  weight_update_every=gnc_every,
                                  burnin_rounds=burnin)
        state = rounds.init_state(Y0, torch.ones(Y0.shape[0], dtype=bool),
                                  edges, data["ppr"])
        out = []
        for _ in range(n_rounds):
            state, _ = fn(state)
            out.append(state)
    return edges, out


def test_round_matches_jax_and_one_rank(tmp_path):
    """2 ranks against JAX's round on a 2-device mesh (2 rounds, within
    1e-5) and against one rank (within 1e-6; bit-identical on the CPU)."""
    g, Y0 = _setup(seed=6)
    data = _data(g, Y0, n_rounds=2, cfg=dict(inner_iters=3),
                 round_kw=dict(weight_update_every=1000))
    two = ranks.run_ranks(ranks.rounds_job, data, tmp_path)
    _, _, sj = _jax_rounds(g, Y0, jrbcd.RbcdConfig(inner_iters=3), 2,
                           weight_update_every=1000)
    _, one = _one_rank(data, 2)
    np.testing.assert_array_equal(two[0]["Ys"][-1], two[1]["Ys"][-1])
    np.testing.assert_allclose(two[0]["Ys"][-1], np.asarray(sj.Y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(two[0]["Ys"][-1], one[-1].Y.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(two[0]["Ys"][-1], one[-1].Y.numpy())


def test_one_rank_round_equals_reference_with_gnc():
    """The one-rank round is `rbcd_round_reference` over the buckets with
    the GNC schedule of the CLI (every 2nd round from round 8), bit for
    bit: 12 rounds."""
    g, Y0 = _setup(seed=8, n_poses=32, outlier_ratio=0.3)
    data = _data(g, Y0)
    edges, states = _one_rank(data, 12, gnc_every=2, burnin=8)
    ppr = data["ppr"]
    Y = torch.from_numpy(data["Y0"])
    buckets = rbcd.bucket_edges(edges, 2, ppr)
    sq = lambda Y: rbcd.lifted_edge_sq_errors(  # noqa: E731
        Y.reshape(-1, *Y.shape[2:]), edges, ppr)
    st = gnc.gnc_init(sq(Y), edges.etype, edges.valid,
                      gnc.barc2_from_quantile(0.9, 6))
    for i in range(12):
        Y = rbcd.rbcd_round_reference(Y, torch.ones(2, dtype=bool), edges,
                                      st.weights, rbcd.RbcdConfig(
                                          inner_iters=3), ppr, buckets)
        if (i + 1) % 2 == 0 and i + 1 >= 8:
            st = gnc.gnc_update_weights(st, sq(Y), edges.etype, edges.valid)
        assert torch.equal(Y, states[i].Y), i
    assert torch.equal(st.weights, states[-1].gnc_state.weights)
    assert states[-1].round_idx == 12


def test_gnc_outlier_rejection_matches_jax(tmp_path):
    """tests/test_rbcd_dist.py::test_sharded_gnc_outlier_rejection's
    setup (2 x 32, 30 % outliers, 60 rounds, weights every 2nd round): the
    same loop closures under 0.5 as the JAX package's rounds (their
    reference semantics, tests/_jax_rounds.py), and its acceptance."""
    g, Y0 = _setup(seed=8, n_poses=32, outlier_ratio=0.3)
    data = _data(g, Y0, n_rounds=60, cfg=dict(inner_iters=5),
                 round_kw=dict(weight_update_every=2))
    w = ranks.run_ranks(ranks.rounds_job, data, tmp_path)[0]["weights"]
    _, sj = jax_rounds.reference_rounds(
        g.edges, Y0, jrbcd.RbcdConfig(inner_iters=5), g.poses_per_robot, 60,
        every=2)
    wj = np.asarray(sj.weights)
    lc = np.asarray(g.edges.valid) & (np.asarray(g.edges.etype) != 1)
    out = np.asarray(g.is_outlier)
    np.testing.assert_array_equal(lc & (w < 0.5), lc & (wj < 0.5))
    assert w[lc & out].max(initial=0.0) < 0.05
    assert w[lc & ~out].min(initial=1.0) > 0.5


def test_deactivated_block_unchanged(tmp_path):
    g, Y0 = _setup(seed=9)
    active = np.asarray(fault.deactivate(torch.ones(2, dtype=bool), 1))
    data = _data(g, Y0, n_rounds=2, active=active,
                 cfg=dict(inner_iters=3))
    Y = ranks.run_ranks(ranks.rounds_job, data, tmp_path)[1]["Ys"][-1]
    np.testing.assert_array_equal(Y[1], np.asarray(Y0[1]))
    assert not np.allclose(Y[0], np.asarray(Y0[0]))


def test_fault_helpers_and_watchdog():
    a = fault.deactivate(torch.ones(3, dtype=bool), 1)
    assert a.tolist() == [True, False, True]
    assert fault.reactivate(a, 1).all() and not a[1]
    fired = []
    wd = fault.RoundWatchdog(0.01, on_timeout=lambda: fired.append(1))
    time.sleep(0.02)
    wd.tick()
    wd.tick()
    assert fired == [1] and wd.timeouts == 1
    hard = fault.RoundWatchdog(0.01, enable_recovery=False)
    time.sleep(0.02)
    with pytest.raises(TimeoutError):
        hard.tick()


def test_checkpoints_cross_packages(tmp_path):
    """A JAX checkpoint loads in the port and the run continues as JAX's
    does (within 1e-5); the port's checkpoint holds JAX's keys and
    dtypes, loads in the JAX package and its run continues; the port's
    resume equals its straight run bit for bit."""
    g, Y0 = _setup(seed=10)
    m, fn, sj = _jax_rounds(g, Y0, jrbcd.RbcdConfig(inner_iters=2), 1)
    pj = str(tmp_path / "jax.npz")
    jckpt.save(pj, sj)
    sj2, _ = fn(sj)
    pp = str(tmp_path / "port.npz")
    res = ranks.run_ranks(ranks.resume_job,
                          _data(g, Y0, load=pj, save=pp), tmp_path)[0]
    assert res["round_idx"] == 2
    np.testing.assert_allclose(res["Y"], np.asarray(sj2.Y), rtol=1e-5,
                               atol=1e-5)
    # the same state handed over as numpy (convert.round_state_from_numpy)
    gs = sj.gnc_state
    conv = convert.round_state_from_numpy(
        np.asarray(sj.Y), np.asarray(sj.active), gs.mu, gs.weights,
        gs.barc2, gs.outer_iter, sj.round_idx, device="cpu")
    loaded = checkpoint.load(pj)
    assert conv.round_idx == loaded.round_idx == 1
    for a, b in ((conv.Y, loaded.Y), (conv.active, loaded.active),
                 (conv.gnc_state.mu, loaded.gnc_state.mu),
                 (conv.gnc_state.weights, loaded.gnc_state.weights),
                 (conv.gnc_state.outer_iter, loaded.gnc_state.outer_iter)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    zj, zp = np.load(pj), np.load(pp)
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype and zj[k].shape == zp[k].shape, k
    sj3, _ = fn(jckpt.load(pp, mesh=m))
    sj3_ref, _ = fn(sj2)
    np.testing.assert_allclose(np.asarray(sj3.Y), np.asarray(sj3_ref.Y),
                               rtol=1e-5, atol=1e-5)
    assert int(sj3.round_idx) == 3
    # the port's own resume: 2 rounds == 1 round, save, load, 1 round
    data = _data(g, Y0)
    edges, straight = _one_rank(data, 2, gnc_every=1, burnin=1)
    checkpoint.save(str(tmp_path / "one.npz"), straight[0])
    st = checkpoint.load(str(tmp_path / "one.npz"))
    with mesh.robot_group(2, "cpu") as group:
        fn1 = rounds.make_round_fn(group, edges, data["ppr"],
                                   rbcd.RbcdConfig(inner_iters=3),
                                   weight_update_every=1, burnin_rounds=1)
        resumed, _ = fn1(st)
    assert torch.equal(resumed.Y, straight[1].Y)
    assert torch.equal(resumed.gnc_state.weights,
                       straight[1].gnc_state.weights)
    assert torch.equal(resumed.gnc_state.mu, straight[1].gnc_state.mu)


def test_comm_bytes_in_the_analytic_band(tmp_path):
    """Bytes received a round, counted by the collectives of 2 ranks with
    2 and 4 robots (tests/test_rbcd_dist.py's band: more with more
    robots, within a factor of 2 of the analytic model); one rank counts
    none and raises, the CLI's cue to use the model."""
    measured, analytic = {}, {}
    for n in (2, 4):
        g, Y0 = _setup(seed=12, n_robots=n, n_poses=16)
        data = _data(g, Y0, n_rounds=1, cfg=dict(inner_iters=2, cg_iters=5),
                     round_kw=dict(weight_update_every=1000))
        measured[n] = ranks.run_ranks(ranks.rounds_job, data,
                                      tmp_path / str(n))[0]["comm"]
        analytic[n] = rounds.round_comm_bytes(Y0.shape, 2)
    assert measured[4] > measured[2] > 0
    for n in (2, 4):
        assert 0.5 < measured[n] / analytic[n] < 2.0, (n, measured, analytic)
    assert measured[2] == analytic[2]
    edges, _ = _one_rank(data, 0)
    with mesh.robot_group(4, "cpu") as group:
        fn = rounds.make_round_fn(group, edges, 16, rbcd.RbcdConfig())
        st = rounds.init_state(torch.from_numpy(data["Y0"]),
                               torch.ones(4, dtype=bool), edges, 16)
        received = group.received
        fn(st)
        with pytest.raises(ValueError, match="no bytes"):
            rounds.measured_round_comm_bytes(group.received - received,
                                             st.Y.shape, group.world, 3)


def _chain_problem(weighted: bool):
    """tests/test_rbcd_dist.py's two chain problems."""
    if not weighted:
        rng = np.random.default_rng(17)
        N = 64
        t_gt = np.cumsum(rng.normal(0, 0.5, (N, 3)), axis=0).astype(
            np.float32)
        t_gt -= t_gt[0]
        d_chain = np.zeros((N, 3), np.float32)
        d_chain[:-1] = t_gt[1:] - t_gt[:-1]
        d_chain[:-1] += rng.normal(0, 0.01, (N - 1, 3)).astype(np.float32)
        lc_src = np.full(8, -1, np.int32)
        lc_dst = np.zeros(8, np.int32)
        lc_d = np.zeros((8, 3), np.float32)
        lc_w = np.zeros(8, np.float32)
        for e in range(5):
            i, j = rng.integers(0, N, 2)
            if i == j:
                continue
            lc_src[e], lc_dst[e] = min(i, j), max(i, j)
            lc_d[e] = t_gt[lc_dst[e]] - t_gt[lc_src[e]]
            lc_w[e] = 4.0
        return dict(n=N, d_chain=d_chain, lc_src=lc_src, lc_dst=lc_dst,
                    lc_d=lc_d, lc_w=lc_w, wc=None, cg_iters=200), t_gt, 0.1
    rng = np.random.default_rng(23)
    Nr = 16
    N = 2 * Nr
    t_gt = np.cumsum(rng.normal(0, 0.5, (N, 3)), axis=0).astype(np.float32)
    t_gt -= t_gt[0]
    d_chain = np.zeros((N, 3), np.float32)
    d_chain[:-1] = t_gt[1:] - t_gt[:-1]
    wc = np.full(N, 2.5, np.float32)
    wc[Nr - 1] = 0.0
    d_chain[Nr - 1] = 999.0
    lc_src = np.full(8, -1, np.int32)
    lc_dst = np.zeros(8, np.int32)
    lc_d = np.zeros((8, 3), np.float32)
    lc_w = np.zeros(8, np.float32)
    for e in range(4):
        i = int(rng.integers(0, Nr))
        j = int(rng.integers(Nr, N))
        lc_src[e], lc_dst[e] = i, j
        lc_d[e] = t_gt[j] - t_gt[i]
        lc_w[e] = 4.0
    return dict(n=N, d_chain=d_chain, lc_src=lc_src, lc_dst=lc_dst,
                lc_d=lc_d, lc_w=lc_w, wc=wc, cg_iters=300), t_gt, 0.05


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["chain", "weighted_fleet_concat"])
def test_chain_solve(weighted, tmp_path):
    """2 chain ranks against the dense least-squares solution and the JAX
    solver on a 2-shard mesh (within 1e-3), and near ground truth."""
    data, t_gt, gt_tol = _chain_problem(weighted)
    got = ranks.run_ranks(ranks.chain_job, data, tmp_path)
    np.testing.assert_array_equal(got[0], got[1])
    ref = jchain.chain_translation_reference(
        data["n"], data["d_chain"], data["lc_src"], data["lc_dst"],
        data["lc_d"], data["lc_w"], w_chain=data["wc"])
    assert np.abs(got[0] - ref).max() < 1e-3
    assert np.abs(got[0] - t_gt).max() < gt_tol
    np.testing.assert_allclose(
        chain.chain_translation_reference(
            data["n"], data["d_chain"], data["lc_src"], data["lc_dst"],
            data["lc_d"], data["lc_w"], w_chain=data["wc"]), ref)
    solver = jchain.make_chain_translation_solver(
        jmesh.robot_mesh(1, intra=2), data["n"], 8,
        cg_iters=data["cg_iters"])
    kw = {} if data["wc"] is None else dict(w_chain=jnp.asarray(data["wc"]))
    tj = np.asarray(solver(*(jnp.asarray(data[k]) for k in (
        "d_chain", "lc_src", "lc_dst", "lc_d", "lc_w")), **kw))
    assert np.abs(got[0] - tj).max() < 1e-3


def _verify_inputs(noise=True):
    """tests/test_rbcd_dist.py's hypothesis-sharding problem: 128 points,
    30 outliers (noise=False: exact correspondences, every model agrees)."""
    rng = np.random.default_rng(13)
    K = 128
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.1, 0.4],
                                               jnp.float32)))
    t_gt = np.array([1.0, 0.5, -0.2], np.float32)
    p = rng.uniform(-4, 4, (K, 3)).astype(np.float32)
    q = (np.einsum("ij,kj->ki", R_gt, p) + t_gt).astype(np.float32)
    if noise:
        q += rng.normal(0, 0.01, (K, 3)).astype(np.float32)
        out_idx = rng.choice(K, 30, replace=False)
        q[out_idx] += rng.uniform(2, 8, (30, 3)).astype(np.float32)
    key = jrng.derive(jrng.base_key(5), jrng.Stream.RANSAC_STEREO)
    return p, q, key


@pytest.mark.parametrize("noise", [True, False], ids=["outliers", "ties"])
def test_split_table_equals_unsplit(noise, tmp_path):
    """2 ranks' split table against the unsplit port `ransac_arun`, bit
    for bit (ties: noise-free points, so every proper model counts all
    128 and the winner is the first hypothesis of rank 0's slice); the
    inlier count against the JAX package's split table on a (1, 2) mesh,
    R and t within 1e-5."""
    p, q, key = _verify_inputs(noise)
    kd = np.asarray(jax.random.key_data(key), np.int64)[None]
    data = dict(key=kd, p=np.ascontiguousarray(p.T[None]),
                q=np.ascontiguousarray(q.T[None]),
                valid=np.ones((1, 128), bool), n_hyp=512)
    got = ranks.run_ranks(ranks.verify_job, data, tmp_path)
    t = lambda k: torch.from_numpy(data[k])  # noqa: E731
    ref = ransac.ransac_arun(t("key"), t("p"), t("q"), t("valid"), n_hyp=512)
    for k in ("R", "t", "inliers", "n_inliers", "ok"):
        np.testing.assert_array_equal(got[0][k], ref[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(got[1][k], ref[k].numpy(), err_msg=k)
    if not noise:
        cnt = [g["cand"][0, 0] for g in got]
        assert cnt[0] == cnt[1] == 128
        assert got[0]["cand"][0, 1] < 256 <= got[1]["cand"][0, 1]
    fn = jsv.make_sharded_arun(jmesh.robot_mesh(1, intra=2), n_hyp=512)
    rj = fn(key, jnp.asarray(p.T), jnp.asarray(q.T), jnp.ones(128, bool))
    assert int(got[0]["n_inliers"][0]) == int(rj["n_inliers"])
    np.testing.assert_allclose(got[0]["R"][0], np.asarray(rj["R"]),
                               atol=1e-5)
    np.testing.assert_allclose(got[0]["t"][0], np.asarray(rj["t"]),
                               atol=1e-5)


def test_merge_takes_the_first_rank_on_a_tie():
    """A tie across ranks goes to the lower rank (the lower global
    index), as the first maximum of the unsplit table; a strictly larger
    count wins from any rank."""
    p, q, _ = _verify_inputs()
    pt = torch.from_numpy(np.ascontiguousarray(p.T[None]))
    qt = torch.from_numpy(np.ascontiguousarray(q.T[None]))
    valid = torch.ones((1, 128), dtype=torch.bool)
    R_gt = torch.from_numpy(np.asarray(jlie.so3_exp(jnp.asarray(
        [0.2, -0.1, 0.4], jnp.float32))))
    good = torch.cat([R_gt.reshape(9), torch.tensor([1.0, 0.5, -0.2])])
    bad = torch.cat([torch.eye(3).reshape(9), torch.zeros(3)])

    def cands(c0, m0, c1, m1):
        return torch.stack([torch.cat([torch.tensor([c0, 3.0]), m0])[None],
                            torch.cat([torch.tensor([c1, 300.0]), m1])[None]])

    tie = sharded_verify.merge_slices(cands(90.0, good, 90.0, bad), pt, qt,
                                      valid)
    assert int(tie["n_inliers"][0]) >= 90
    tie2 = sharded_verify.merge_slices(cands(90.0, bad, 90.0, good), pt, qt,
                                       valid)
    assert int(tie2["n_inliers"][0]) < 90
    win1 = sharded_verify.merge_slices(cands(89.0, bad, 90.0, good), pt, qt,
                                       valid)
    assert int(win1["n_inliers"][0]) >= 90


@pytest.mark.parametrize("world", [1, 2])
def test_dryrun_multichip(world, tmp_path):
    """The four distributed stages over 1 rank (in this process) and 2
    (spawned): finite results, every verification accepted."""
    if world == 1:
        from kimera_multi_tpu_torch.entry import dryrun_multichip

        outs = [dryrun_multichip(1, device="cpu")]
    else:
        outs = ranks.run_ranks(ranks.dryrun_job, {}, tmp_path)
        assert outs[0] == outs[1]
    for o in outs:
        assert o["ok"] and o["n_inliers"] >= 30
        assert np.isfinite(o["round_cost"]) and np.isfinite(o["chain_t_max"])
