"""The port's deformation graph (`solve/deformation.py`) against the JAX
package's, on the CPU, on inputs made from a seed with numpy: tests/
test_deformation.py's strip and grid graphs, and a random graph with
repeated node positions (a robot standing still).

Tolerances: `build_graph_knn` and `skinning` indices equal, ties
included (the lower node index first, as `jax.lax.top_k`), skinning
weights within 1e-6; `residuals` within 1e-5; the written-out J^T r and
J v (`jt` / `jv` inside `solve`, read through one Gauss-Newton step of
one CG step) against `jax.linearize` / `jax.vjp` within 1e-5; `solve`
after 4 x 30 steps (the port solves in float64): node translations and
rotations within 1e-5 of the JAX package's solve run in float64
(`jax.enable_x64`; 3.4e-6 measured: the system is ill-conditioned and
the two packages add in different orders), within 2e-2 of its float32
solve (whose own float32 CG drift on this strip is 9e-3 m), and the
constraints met as closely as JAX meets them (within 1e-3 m);
`deform_vertices` from the same state within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.solve import deformation as jdfm
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.solve import deformation as dfm

torch.set_num_threads(1)


def _grid_nodes(nx=6, ny=4, spacing=1.0):
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    return np.stack([xs.ravel() * spacing, ys.ravel() * spacing,
                     np.zeros(nx * ny)], -1).astype(np.float32)


def _walk(seed, G=40):
    """An odometry-like chain with repeated positions."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.3, (G, 3)).astype(np.float32)
    steps[rng.random(G) < 0.25] = 0.0
    return np.cumsum(steps, 0).astype(np.float32)


def _graphs(pos, k):
    g = dfm.build_graph_knn(torch.from_numpy(pos), k=k)
    gj = jdfm.build_graph_knn(jnp.asarray(pos), k=k)
    return g, gj


@pytest.mark.parametrize("case", ["grid", "walk"])
def test_build_graph_knn_and_skinning(case):
    pos = _grid_nodes() if case == "grid" else _walk(1)
    for k in (3, 4):
        g, gj = _graphs(pos, k)
        assert np.array_equal(g.edge_src.numpy(), np.asarray(gj.edge_src))
        assert np.array_equal(g.edge_dst.numpy(), np.asarray(gj.edge_dst))
        assert g.edge_valid.all()
    rng = np.random.default_rng(2)
    verts = np.concatenate([pos[:10], rng.uniform(
        pos.min(0), pos.max(0) + 1e-3, (200, 3))]).astype(np.float32)
    idx, w = dfm.skinning(torch.from_numpy(verts), torch.from_numpy(pos), 4)
    idx_j, w_j = jdfm.skinning(jnp.asarray(verts), jnp.asarray(pos), 4)
    assert np.array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)


def _problem(seed):
    """The strip of tests/test_deformation.py bent by 2 at its far end,
    plus a random state to linearize at."""
    pos = _grid_nodes(nx=8, ny=2)
    far = np.nonzero(pos[:, 0] > 6.5)[0]
    near = np.nonzero(pos[:, 0] < 0.5)[0]
    con = np.concatenate([far, near]).astype(np.int32)
    target = pos[con].copy()
    target[:len(far), 2] += 2.0
    ok = np.ones(len(con), bool)
    ok[-1] = False  # an invalid constraint
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.2, (len(pos), 3)).astype(np.float32)
    t = rng.normal(0, 0.3, (len(pos), 3)).astype(np.float32)
    return pos, con, target, ok, w, t


def test_residuals_and_linearization():
    from kimera_multi_tpu_torch.core import lie

    pos, con, target, ok, w, t = _problem(3)
    R = lie.so3_exp(torch.from_numpy(w)).numpy()
    g, gj = _graphs(pos, 3)
    cfg, cfg_j = dfm.DeformationConfig(), jdfm.DeformationConfig()
    st = convert.deformation_state_from_numpy(R, t, device="cpu")
    st_j = jdfm.DeformationState(R=jnp.asarray(R), t=jnp.asarray(t))
    args = (torch.from_numpy(con), torch.from_numpy(target),
            torch.from_numpy(ok))
    args_j = (jnp.asarray(con), jnp.asarray(target), jnp.asarray(ok))
    r = dfm.residuals(st, g, *args, cfg)
    r_j = jdfm.residuals(st_j, gj, *args_j, cfg_j)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-5)

    # one Gauss-Newton step of one CG step from delta = 0 is
    # x = -(g.g / g.(J^T J + damping) g) g with g = J^T r: it reads the
    # written-out J^T and J v against jax.linearize / jax.vjp
    def f(d):
        return jdfm.residuals(jdfm.retract(st_j, d), gj, *args_j, cfg_j)

    d0 = jnp.zeros((len(pos), 6))
    r0, jvp = jax.linearize(f, d0)
    _, vjp = jax.vjp(f, d0)
    gv = vjp(r0)[0]
    hg = vjp(jvp(gv))[0] + cfg_j.damping * gv
    x_j = -(jnp.sum(gv * gv) / jnp.sum(gv * hg)) * gv
    one = dfm.DeformationConfig(gn_iters=1, cg_iters=1)
    out = dfm.solve(st, g, *args, one)
    ref = jdfm.retract(st_j, x_j)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-5)
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-5)


def test_solve_and_deform_vertices():
    pos, con, target, ok, _, _ = _problem(4)
    G = len(pos)
    g, gj = _graphs(pos, 3)
    cfg = dfm.DeformationConfig(gn_iters=4, cg_iters=30)
    cfg_j = jdfm.DeformationConfig(gn_iters=4, cg_iters=30)
    st = dfm.solve(dfm.identity_state(G, device="cpu"), g,
                   torch.from_numpy(con), torch.from_numpy(target),
                   torch.from_numpy(ok), cfg)
    st_j = jdfm.solve(jdfm.identity_state(G), gj, jnp.asarray(con),
                      jnp.asarray(target), jnp.asarray(ok), cfg_j)
    # the port solves in float64: against the JAX package's solve in
    # float64 closely, against its float32 solve within its float32 drift
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa
        gj64 = jdfm.build_graph_knn(f64(pos), k=3)
        st_64 = jdfm.solve(jdfm.identity_state(G), gj64, jnp.asarray(con),
                           f64(target), jnp.asarray(ok), cfg_j)
        t64, R64 = np.asarray(st_64.t), np.asarray(st_64.R)
    assert t64.dtype == np.float64
    np.testing.assert_allclose(st.t.numpy(), t64, atol=1e-5)
    np.testing.assert_allclose(st.R.numpy(), R64, atol=1e-5)
    np.testing.assert_allclose(st.t.numpy(), np.asarray(st_j.t), atol=2e-2)
    np.testing.assert_allclose(st.R.numpy(), np.asarray(st_j.R), atol=2e-2)
    moved = pos + st.t.numpy()
    moved_j = pos + np.asarray(st_j.t)
    m = ok
    err = np.abs(moved[con[m]] - target[m]).max()
    err_j = np.abs(moved_j[con[m]] - target[m]).max()
    assert err <= err_j + 1e-3 and err < 0.1
    # re-skinning from the same (JAX) state
    rng = np.random.default_rng(0)
    verts = np.stack([rng.uniform(0, 7, 200), rng.uniform(0, 1, 200),
                      np.zeros(200)], -1).astype(np.float32)
    sidx, sw = jdfm.skinning(jnp.asarray(verts), gj.node_pos, k=4)
    want = jdfm.deform_vertices(jnp.asarray(verts), gj, st_j, sidx, sw)
    got = dfm.deform_vertices(
        torch.from_numpy(verts), g,
        convert.deformation_state_from_numpy(np.asarray(st_j.R),
                                             np.asarray(st_j.t), "cpu"),
        torch.from_numpy(np.asarray(sidx)), torch.from_numpy(np.asarray(sw)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rigid_translation_interpolates():
    """tests/test_deformation.py's first case on the port: a few nodes
    constrained to a rigid translation drag the whole graph along."""
    pos = _grid_nodes()
    G = len(pos)
    graph = dfm.build_graph_knn(torch.from_numpy(pos), k=4)
    shift = np.array([0.5, -0.3, 0.8], np.float32)
    con = np.asarray([0, 5, G - 1, G - 6], np.int32)
    state = dfm.solve(dfm.identity_state(G, device="cpu"), graph,
                      torch.from_numpy(con),
                      torch.from_numpy(pos[con] + shift),
                      torch.ones(4, dtype=torch.bool))
    assert np.allclose(pos + state.t.numpy(), pos + shift, atol=0.05)
