"""The port's back-end (`solve/rbcd.py`, `solve/gnc.py`) against the JAX
package's, on the CPU, on the graphs of tests/test_rbcd_dist.py (2 robots
x 24 poses; 3 x 16 for the bucketed == masked round), carried across as
numpy arrays by `convert`. Each test compiles one JAX function for the
quantities it reads (the workers of a parallel run would otherwise each
compile every quantity of a shared fixture).

Tolerances. The port's gradient, Hessian-vector product and chord
coefficients are written out (rbcd.py's docstring), and its reductions
onto poses sum along an incidence table, where the JAX package's autodiff
scatter-adds; so the two sum in other orders, and CG amplifies the
difference:
  * lifted cost, per-edge squared errors: 1e-5 relative;
  * block-Jacobi preconditioner: 1e-5 relative to its largest entry;
  * block Newton directions: 1e-5 of their largest entry;
  * one round (2 cycles at 3 x 16, with its exact-chord step and polar
    retraction): 1e-5 absolute on blocks of norm up to 10;
  * GNC weights and mu: 1e-6 on the same squared errors.
Inside the port the bucketed and the masked paths take the same slots in
the same order, so they agree exactly; `_spd4_inv` is held to float64
`numpy.linalg.inv` as tests/test_rbcd_dist.py holds JAX's. `solve_rounds`
meets tests/test_rbcd_dist.py's bounds: after 20 rounds the cost is below
0.2 x its value at Y0 and the rounded trajectory's ATE under 0.7."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported here, not first inside a jitted round: the JAX package's
# stiefel_project imports kimera_multi_tpu.kernels lazily, and a module
# constant made while a trace is open (kernels/hamming.py's _BITS) would be
# a tracer that leaks into every later trace of the process
import kimera_multi_tpu.kernels  # noqa: F401
from kimera_multi_tpu.core import rng as jrng, stiefel as jst
from kimera_multi_tpu.io.synthetic import multi_robot_graph as jgraph
from kimera_multi_tpu.solve import gnc as jgnc, pgo as jpgo, rbcd as jrbcd
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import lie, rng, stiefel
from kimera_multi_tpu_torch.io import synthetic
from kimera_multi_tpu_torch.solve import gnc, pgo, rbcd

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")


def _setup(seed, n_robots, n_poses, outlier_ratio=0.0):
    """tests/test_rbcd_dist.py's `_setup`: the JAX package's graph (numpy),
    carried into the port by `convert`, and Y0 (odometry initialization
    lifted by the LIFTING key's matrix) made by the port and handed to
    both packages."""
    gj = jgraph(seed=seed, n_robots=n_robots, n_poses=n_poses,
                outlier_ratio=outlier_ratio, n_intra_lc=4, n_inter_lc=6)
    edges = convert.edges_from_numpy(
        **{f: np.asarray(getattr(gj.edges, f)) for f in FIELDS},
        device="cpu")
    p0 = pgo.init_from_odometry(edges, n_robots, n_poses)
    ylift = stiefel.random_lifting_matrix(
        rng.derive(rng.base_key(0), rng.Stream.LIFTING), 5, 3)
    Y0 = rbcd.lift_params(p0, ylift, n_robots, n_poses)
    return gj, jnp.asarray(Y0.numpy()), edges, Y0


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def g24():
    """2 x 24 with outliers and uneven weights, in both packages."""
    gj, Y0j, edges, Y0 = _setup(5, 2, 24, outlier_ratio=0.3)
    w = np.random.default_rng(1).uniform(
        0.3, 1.0, edges.capacity).astype(np.float32)
    cfg = rbcd.RbcdConfig()

    def want(*names):
        """The named quantities of the JAX package at Y0, compiled for
        these alone."""
        n_robots, N = 2, 24
        e = gj.edges
        bj = jrbcd.bucket_edges(e, n_robots)

        def quantities(Y, w):
            flat = Y.reshape(-1, 5, 4)
            robots = jnp.arange(n_robots)
            sq = jrbcd.lifted_edge_sq_errors(flat, e, N)
            g0 = jgnc.gnc_init(sq, e.etype, e.valid,
                               jgnc.barc2_from_quantile(0.9, 6))
            g1 = jgnc.gnc_update_weights(g0, sq * 0.5, e.etype, e.valid)
            g2 = jgnc.gnc_update_weights(g1, sq * 0.02, e.etype, e.valid)
            q = dict(
                cost=lambda: jrbcd.lifted_cost(flat, e, w, N),
                sq=lambda: sq,
                block_cost=lambda: jax.vmap(lambda r: jrbcd._block_cost(
                    Y[r], Y, r, e, w))(robots),
                precond=lambda: jax.vmap(lambda r, b: jrbcd.bucket_precond(
                    b, r, w, N))(robots, bj),
                masked_precond=lambda: jax.vmap(
                    lambda r: jrbcd.masked_precond(e, r, w, N))(robots),
                dir_bucketed=lambda: jax.vmap(
                    lambda r, b: jrbcd.block_direction_bucketed(
                        Y[r], Y, r, b, w, cfg))(robots, bj),
                dir_masked=lambda: jax.vmap(lambda r: jrbcd.block_direction(
                    Y[r], Y, r, e, w, cfg))(robots),
                mu0=lambda: g0.mu, mu1=lambda: g1.mu, w1=lambda: g1.weights,
                mu2=lambda: g2.mu, w2=lambda: g2.weights)
            return {k: q[k]() for k in names}

        out = jax.jit(quantities)(Y0j, jnp.asarray(w))
        return {k: np.asarray(v) for k, v in out.items()}

    return gj, edges, Y0, torch.from_numpy(w), cfg, want


@pytest.fixture(scope="module")
def g16():
    """3 x 16: one round in both packages, masked or bucketed."""
    gj, Y0j, edges, Y0 = _setup(7, 3, 16)
    cfg = rbcd.RbcdConfig(inner_iters=2)

    def want(path):
        bj = jrbcd.bucket_edges(gj.edges, 3) if path == "bucketed" else None
        return np.asarray(jax.jit(lambda Y: jrbcd.rbcd_round_reference(
            Y, jnp.ones(3, bool), gj.edges, jnp.ones(gj.edges.capacity),
            cfg, buckets=bj))(Y0j))

    return gj, edges, Y0, cfg, want


def test_lifted_cost_and_edge_errors_match_jax(g24):
    gj, edges, Y0, w, cfg, want = g24
    want = want("cost", "sq", "block_cost")
    flat = Y0.reshape(-1, 5, 4)
    cost = rbcd.lifted_cost(flat, edges, w, 24)
    assert cost.shape == () and _rel(cost.numpy(), want["cost"]) < 1e-5
    sq = rbcd.lifted_edge_sq_errors(flat, edges, 24).numpy()
    np.testing.assert_allclose(sq, want["sq"], rtol=1e-5,
                               atol=1e-5 * want["sq"].max())
    # a batch of points: one cost each
    two = rbcd.lifted_cost(torch.stack([flat, 2 * flat]), edges, w, 24)
    assert two.shape == (2,) and torch.equal(two[0], cost)
    # the block costs cover each robot's edges
    bc = rbcd._block_cost(Y0, Y0, torch.arange(2), edges, w).numpy()
    np.testing.assert_allclose(bc, want["block_cost"], rtol=1e-5)
    b = rbcd.bucket_edges(edges, 2, 24)
    bb = rbcd._block_cost_bucketed(Y0, Y0, torch.arange(2), b, w[b.idx])
    # the same terms, summed over a bucket instead of every edge slot
    np.testing.assert_allclose(bb.numpy(), bc, rtol=1e-6)


def test_spd4_inv_matches_lu():
    """The port's closed-form Schur-split 4x4 inverse against float64
    LAPACK, as tests/test_rbcd_dist.py holds the JAX one."""
    npr = np.random.default_rng(3)
    A = npr.normal(0, 1, (64, 4, 4)).astype(np.float32)
    H = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(4, dtype=np.float32)
    got = rbcd._spd4_inv(torch.from_numpy(H)).numpy()
    want = np.linalg.inv(H.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_bucket_edges_and_incidence_tables(g24):
    gj, edges, *_ = g24
    bj = jrbcd.bucket_edges(gj.edges, 2)
    b = rbcd.bucket_edges(edges, 2, 24)
    for f in jrbcd.EdgeBuckets._fields:
        assert np.array_equal(getattr(b, f).numpy(),
                              np.asarray(getattr(bj, f))), f
    # every valid own slot reaches its pose exactly once, in slot order
    for table, rob2, idx2, ok2 in (
            (b.inc, torch.cat([b.src_robot, b.dst_robot], 1),
             torch.cat([b.src_pose, b.dst_pose], 1),
             torch.cat([b.valid, b.valid], 1)),
            (rbcd.masked_incidence(edges, torch.arange(2), 24),
             torch.cat([edges.src_robot, edges.dst_robot]).expand(2, -1),
             torch.cat([edges.src_pose, edges.dst_pose]).expand(2, -1),
             torch.cat([edges.valid, edges.valid]).expand(2, -1))):
        S = rob2.shape[1]
        for r in range(2):
            t = table[r].numpy()
            own = np.nonzero((ok2[r] & (rob2[r] == r)).numpy())[0]
            listed = t[t < S]
            assert sorted(listed) == list(own)
            for p in range(t.shape[0]):
                row = t[p][t[p] < S]
                assert (idx2[r].numpy()[row] == p).all()
                assert (np.diff(row) > 0).all() and (t[p][len(row):] == S).all()
    # a table covers exactly the poses it is asked for, and rows of the
    # masked table for some robots are those robots' rows
    with pytest.raises(ValueError):
        rbcd.bucket_edges(edges, 2, 23)
    one = rbcd.masked_incidence(edges, torch.tensor([1]), 24)
    full = rbcd.masked_incidence(edges, torch.arange(2), 24)
    assert torch.equal(one[0], full[1, :, : one.shape[2]])
    assert (full[1, :, one.shape[2]:] == 2 * edges.capacity).all()


def test_preconditioner_matches_jax(g24):
    gj, edges, Y0, w, cfg, want = g24
    want = want("precond", "masked_precond")
    robots = torch.arange(2)
    b = rbcd.bucket_edges(edges, 2, 24)
    got = rbcd.bucket_precond(b, robots, w, 24)
    assert got.shape == (2, 24, 4, 4)
    assert _rel(got.numpy(), want["precond"]) < 1e-5
    masked = rbcd.masked_precond(edges, robots, w, 24)
    assert _rel(masked.numpy(), want["masked_precond"]) < 1e-5
    assert torch.equal(masked, got)


def test_block_directions_match_jax_and_each_other(g24):
    gj, edges, Y0, w, cfg, want = g24
    want = want("dir_bucketed", "dir_masked")
    robots = torch.arange(2)
    b = rbcd.bucket_edges(edges, 2, 24)
    d_b = rbcd.block_direction_bucketed(Y0, Y0, robots, b, w, cfg)
    d_m = rbcd.block_direction(Y0, Y0, robots, edges, w, cfg)
    assert torch.equal(d_b, d_m)
    assert _rel(d_b.numpy(), want["dir_bucketed"]) < 1e-5
    assert _rel(d_m.numpy(), want["dir_masked"]) < 1e-5
    # one robot at a time gives its row of the batch
    one = rbcd.block_direction_bucketed(Y0[1:], Y0, robots[1:],
                                        rbcd.bucket_slice(b, robots[1:]), w,
                                        cfg)
    assert torch.equal(one[0], d_b[1])
    # unpreconditioned CG runs too, and descends
    d0 = rbcd.block_direction(Y0, Y0, robots, edges, w,
                              cfg._replace(precond=False))
    flat = lambda Y: Y.reshape(-1, 5, 4)
    c0 = rbcd.lifted_cost(flat(Y0), edges, w, 24)
    assert rbcd.lifted_cost(flat(Y0 + 0.1 * d0), edges, w, 24) < c0


@pytest.mark.parametrize("path", ["masked", "bucketed"])
def test_round_matches_jax(g16, path):
    gj, edges, Y0, cfg, want = g16
    buckets = rbcd.bucket_edges(edges, 3, 16) if path == "bucketed" else None
    act = torch.ones(3, dtype=torch.bool)
    w = torch.ones(edges.capacity)
    Y = rbcd.rbcd_round_reference(Y0, act, edges, w, cfg, buckets=buckets)
    np.testing.assert_allclose(Y.numpy(), want(path), rtol=0, atol=1e-5)
    other = rbcd.rbcd_round_reference(
        Y0, act, edges, w, cfg,
        buckets=(None if buckets is not None
                 else rbcd.bucket_edges(edges, 3, 16)))
    assert torch.equal(Y, other)  # bucketed == masked, exactly
    # an inactive robot's block only takes the retraction's polar
    # re-projection (as in the JAX package): its translations stay
    act[1] = False
    Yi = rbcd.rbcd_round_reference(Y0, act, edges, w, cfg, buckets=buckets)
    assert torch.equal(Yi[1, ..., 3], Y0[1, ..., 3])
    np.testing.assert_allclose(Yi[1].numpy(), Y0[1].numpy(), atol=1e-5)
    assert not torch.allclose(Yi[0], Y0[0], atol=1e-2)


def test_solve_rounds_converges():
    """tests/test_rbcd_dist.py::test_rbcd_reference_converges, on the
    port: 20 rounds of 5 cycles from the odometry initialization."""
    g = synthetic.multi_robot_graph(seed=5, n_robots=2, n_poses=24,
                                    outlier_ratio=0.0, n_intra_lc=4,
                                    n_inter_lc=6, device="cpu")
    p0 = pgo.init_from_odometry(g.edges, 2, 24)
    ylift = stiefel.random_lifting_matrix(
        rng.derive(rng.base_key(0), rng.Stream.LIFTING), 5, 3)
    Y0 = rbcd.lift_params(p0, ylift, 2, 24)
    act = torch.ones(2, dtype=torch.bool)
    cfg = rbcd.RbcdConfig(inner_iters=5)
    Y, costs = rbcd.solve_rounds(Y0, act, g.edges, 24, cfg, n_rounds=20)
    assert costs.shape == (20,)
    c_init = float(rbcd.lifted_cost(Y0.reshape(-1, 5, 4), g.edges,
                                    torch.ones(g.edges.capacity), 24))
    assert float(costs[-1]) < 0.2 * c_init
    assert float(costs[-1]) <= float(costs.min()) * 1.05
    R, t = stiefel.round_solution(Y.reshape(-1, 5, 4), 3)
    # left gauge alignment at pose 0 (eval.ape.align_left)
    Ri, ti = lie.se3_inverse(R[0], t[0])
    Ra, ta = lie.se3_compose(g.R_gt[0], g.t_gt[0], Ri, ti)
    _, t_al = lie.se3_compose(Ra.expand(48, 3, 3), ta.expand(48, 3), R, t)
    ate = float(torch.max(torch.linalg.vector_norm(t_al - g.t_gt, dim=-1)))
    assert ate < 0.7


def test_gnc_matches_jax(g24):
    gj, edges, Y0, w, cfg, want = g24
    want = want("sq", "mu0", "mu1", "w1", "mu2", "w2")
    sq = torch.from_numpy(want["sq"])
    barc2 = gnc.barc2_from_quantile(0.9, 6)
    assert barc2 == 10.6446
    with pytest.raises(ValueError):
        gnc.barc2_from_quantile(0.5, 6)
    g0 = gnc.gnc_init(sq, edges.etype, edges.valid, barc2)
    np.testing.assert_allclose(float(g0.mu), want["mu0"], rtol=1e-6)
    g1 = gnc.gnc_update_weights(g0, sq * 0.5, edges.etype, edges.valid)
    g2 = gnc.gnc_update_weights(g1, sq * 0.02, edges.etype, edges.valid)
    for got, k in ((g1, "1"), (g2, "2")):
        np.testing.assert_allclose(float(got.mu), want["mu" + k], rtol=1e-6)
        np.testing.assert_allclose(got.weights.numpy(), want["w" + k],
                                   rtol=0, atol=1e-6)
    assert int(g2.outer_iter) == 2
    # loop closures down-weighted into [0, 1], odometry kept at 1,
    # padding at 0
    lc = (edges.valid & (edges.etype != 1)).numpy()
    w2 = g2.weights.numpy()
    assert (w2[lc] < 0.01).any() and ((w2 >= 0) & (w2 <= 1)).all()
    assert (w2[(edges.etype == 1).numpy()] == 1).all()
    assert (w2[~edges.valid.numpy()] == 0).all()
    st = convert.gnc_state_from_numpy(want["mu2"], want["w2"], barc2, 2,
                                      device="cpu")
    assert torch.equal(st.weights, torch.from_numpy(want["w2"]))



def test_rbcd_path_has_no_autodiff_and_no_float_scatter():
    """The RBCD round's derivatives are written out and its sums onto
    poses gather along an incidence table: no autograd, no torch.func, no
    scatter-add (an atomic on the card) in the modules it runs."""
    import ast
    import inspect

    from kimera_multi_tpu_torch.core import lie as tlie
    from kimera_multi_tpu_torch.kernels import linalg as tlinalg

    banned = {"autograd", "func", "grad", "backward", "index_add",
              "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
              "scatter_reduce_", "index_put", "index_put_", "index_reduce",
              "index_reduce_"}
    for mod in (rbcd, gnc, stiefel, tlie, tlinalg):
        names = {n.attr for n in ast.walk(ast.parse(inspect.getsource(mod)))
                 if isinstance(n, ast.Attribute)}
        assert not names & banned, (mod.__name__, names & banned)

def gnc_schedule_reference(max_rounds=120, seed=2, n_robots=6,
                           n_poses=256, settle=10):
    """The GNC schedule `chip_smoke.py` runs, in the JAX package on the CPU
    (dist/rounds.py's order, cli/run.py's cadence: `gnc_init` from the
    lifted squared errors at Y0, then `gnc_update_weights` after every 2nd
    round from round 8), on bench.py's 6 x 256 graph.

    Every ground-truth outlier loop closure weighs under 0.1 from the
    first update on, while mu is still tiny and every loop closure is
    down-weighted; the inliers come back as mu anneals. So the run goes on
    until, besides, mu has reached 1 and the set of loop closures under
    0.5 has not changed for `settle` rounds; the rounds are counted to its
    last change.
    Returns those rounds, the loop closures (edge indices) under 0.5 and
    the outliers under 0.1 there, and the loop closures within 0.05 of
    0.5."""
    gj = jgraph(seed=seed, n_robots=n_robots, n_poses=n_poses,
                outlier_ratio=0.2, n_intra_lc=16, n_inter_lc=16)
    e = gj.edges
    p0 = jpgo.init_from_odometry(e, n_robots, n_poses)
    ylift = jst.random_lifting_matrix(
        jrng.derive(jrng.base_key(0), jrng.Stream.LIFTING), 5, 3)
    Y = jrbcd.lift_params(p0, ylift, n_robots, n_poses)
    cfg = jrbcd.RbcdConfig()
    buckets = jrbcd.bucket_edges(e, n_robots)
    act = jnp.ones(n_robots, bool)
    sq = lambda Y: jrbcd.lifted_edge_sq_errors(Y.reshape(-1, 5, 4), e,
                                               n_poses)
    state = jgnc.gnc_init(sq(Y), e.etype, e.valid,
                          jgnc.barc2_from_quantile(0.9, 6))
    step = jax.jit(lambda Y, w: jrbcd.rbcd_round_reference(
        Y, act, e, w, cfg, n_poses, buckets))
    update = jax.jit(lambda s, Y: jgnc.gnc_update_weights(
        s, sq(Y), e.etype, e.valid))
    out = np.asarray(gj.is_outlier)
    lc = np.asarray(e.valid) & (np.asarray(e.etype) != 1)
    sets, weights = [], []
    for i in range(max_rounds):
        Y = step(Y, state.weights)
        if (i + 1) % 2 == 0 and i + 1 >= 8:
            state = update(state, Y)
        w = np.asarray(state.weights)
        weights.append(w)
        sets.append(tuple(np.nonzero(lc & (w < 0.5))[0]))
        if (w[out] < 0.1).all() and float(state.mu) >= 1.0 \
                and len(set(sets[-settle - 1:])) == 1:
            break
    else:
        raise RuntimeError("the GNC schedule did not settle")
    rounds = next(r for r in range(len(sets), 0, -1)
                  if sets[r - 1] != sets[-1]) + 1
    w = weights[rounds - 1]
    return dict(rounds=rounds, under_05=list(map(int, sets[rounds - 1])),
                outliers_under_01=np.nonzero(out & (w < 0.1))[0].tolist(),
                near_05=np.nonzero(lc & (np.abs(w - 0.5) <= 0.05))[0]
                .tolist(), n_outliers=int(out.sum()), n_lc=int(lc.sum()),
                mu=float(state.mu))


def round_error_reference(seed=2, n_robots=6, n_poses=256):
    """One bucketed round on bench.py's 6 x 256 graph from the odometry
    start, in the JAX package, in the port (float32) and in the port in
    float64: the largest and mean differences between them."""
    import dataclasses

    gj = jgraph(seed=seed, n_robots=n_robots, n_poses=n_poses,
                outlier_ratio=0.2, n_intra_lc=16, n_inter_lc=16)
    edges = convert.edges_from_numpy(
        **{f: np.asarray(getattr(gj.edges, f)) for f in FIELDS},
        device="cpu")
    p0 = pgo.init_from_odometry(edges, n_robots, n_poses)
    Y0 = rbcd.lift_params(p0, stiefel.random_lifting_matrix(
        rng.derive(rng.base_key(0), rng.Stream.LIFTING), 5, 3),
        n_robots, n_poses)
    bj = jrbcd.bucket_edges(gj.edges, n_robots)
    Yj = np.asarray(jax.jit(lambda Y: jrbcd.rbcd_round_reference(
        Y, jnp.ones(n_robots, bool), gj.edges, jnp.ones(gj.edges.capacity),
        jrbcd.RbcdConfig(), n_poses, bj))(jnp.asarray(Y0.numpy())))
    out = {}
    for dt in (torch.float32, torch.float64):
        e = dataclasses.replace(edges, **{
            f: getattr(edges, f).to(dt) for f in ("R", "t", "kappa", "tau")})
        out[dt] = rbcd.rbcd_round_reference(
            Y0.to(dt), torch.ones(n_robots, dtype=torch.bool), e,
            torch.ones(e.capacity, dtype=dt), rbcd.RbcdConfig(), n_poses,
            rbcd.bucket_edges(e, n_robots, n_poses)).numpy()
    Yt, Y64 = out[torch.float32], out[torch.float64]
    d = lambda a, b: (float(np.abs(a - b).max()), float(np.abs(a - b).mean()))
    return {"jax_vs_port": d(Yj, Yt), "port_vs_float64": d(Yt, Y64),
            "jax_vs_float64": d(Yj, Y64), "max_abs_block": float(
                np.abs(Y64).max())}


if __name__ == "__main__":
    # env JAX_PLATFORMS=cpu python tests/test_torch_rbcd.py
    print(gnc_schedule_reference())
    print(round_error_reference())
