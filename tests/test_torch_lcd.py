"""Islands and single-database detection of the port against the JAX
package's, on the CPU, with exact ties on purpose: equal positive island
scores, runs of zeros, a max_db_results cut through a run of equal
scores, equal database frames. Both take the lower index first among
equals (`jax.lax.top_k` order).

Tolerance: match ids and validity are compared exactly; island scores
within rtol 1e-6 (the port sums an island in float64, XLA in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.frontend import bow_db as jdb, lcd as jl
from kimera_multi_tpu.kernels import bow as jbow
from kimera_multi_tpu_torch.frontend import bow_db as tdb, lcd as tl
from kimera_multi_tpu_torch.kernels import bow as tbow

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _tied_scores():
    """Rows of normalized scores (N = 40) with ties of every kind."""
    rows = np.zeros((6, 40), np.float32)
    # two islands of equal sum: the first must win
    rows[0, [3, 4, 5]] = [0.5, 0.9, 0.5]
    rows[0, [20, 21, 22]] = [0.5, 0.9, 0.5]
    # equal maxima inside an island: the first member represents it
    rows[1, [7, 8, 10]] = [0.8, 0.8, 0.6]
    rows[1, [30, 31]] = [0.6, 0.6]
    # max_db_results cut through a run of equal scores
    rows[2, :12] = 0.7
    rows[2, 12] = 0.95
    rows[2, [25, 26, 33]] = 0.7
    # all zero, and all below alpha
    rows[4, :] = 0.2
    # many islands of equal score, gaps of exactly max_intraisland_gap
    rows[5, ::5] = 0.6
    rows[5, 1::10] = 0.6
    return rows


P_CASES = [
    jl.LcdParams(),
    jl.LcdParams(max_db_results=4),
    jl.LcdParams(max_db_results=13, max_intraisland_gap=1, alpha=0.55),
    jl.LcdParams(max_intraisland_gap=0, alpha=0.1),
]


@pytest.mark.parametrize("pi", range(len(P_CASES)))
@pytest.mark.parametrize("n_cand", [1, 3, 50])
def test_top_islands(pi, n_cand):
    params = P_CASES[pi]
    rows = _tied_scores()
    f = jax.jit(lambda s: jax.vmap(
        lambda r: jl.top_islands(r, params, n_cand))(s))
    jm, js, jvalid = (np.asarray(x) for x in f(jnp.asarray(rows)))
    tparams = tl.LcdParams(*params)
    tm, ts, tvalid = tl.top_islands(torch.from_numpy(rows), tparams, n_cand)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    # one row at a time gives the same
    m1, _, v1 = tl.top_islands(torch.from_numpy(rows[0]), tparams, n_cand)
    np.testing.assert_array_equal(m1.numpy(), jm[0])
    np.testing.assert_array_equal(v1.numpy(), jvalid[0])


def _tied_db(n=24, W=8, seed=0):
    """A database whose frames repeat in pairs (exact score ties) and a
    query sharing words with some of them."""
    rs = np.random.default_rng(seed)
    ids = np.stack([rs.permutation(30)[:W] for _ in range(n // 2)])
    ids = np.repeat(ids, 2, axis=0).astype(np.int32)
    w = rs.uniform(0.1, 1, (n // 2, W)).astype(np.float32)
    w = np.repeat(w / w.sum(-1, keepdims=True), 2, axis=0)
    q = ids[6].copy()
    q[W // 2:] = ids[15, W // 2:]
    qw = np.full(W, 1.0 / W, np.float32)
    return ids, w.astype(np.float32), q, qw


@pytest.mark.parametrize("mode", ["plain", "self", "temporal"])
def test_detect(mode):
    ids, w, q, qw = _tied_db()
    n = ids.shape[0]
    jd, td = jdb.empty(n, 8), tdb.empty(n, 8, device="cpu")
    for f in range(n - 2):
        jd = jdb.add(jd, jnp.int32(f), jnp.asarray(ids[f]), jnp.asarray(w[f]))
        td = tdb.add(td, f, torch.from_numpy(ids[f]), torch.from_numpy(w[f]))
    jq = jbow.sort_bow(jnp.asarray(q), jnp.asarray(qw))
    tq = tbow.sort_bow(torch.from_numpy(q), torch.from_numpy(qw))
    kw_j, kw_t = {}, {}
    params = jl.LcdParams(alpha=0.1, max_db_results=5)
    if mode == "self":
        kw_j["self_query_frame"] = jnp.int32(25)
        kw_t["self_query_frame"] = 25
        params = params._replace(recent_frames_window=12)
    if mode == "temporal":
        params = params._replace(min_temporal_matches=2)
    results = []
    for prev in (-1, 18, 30):  # the best island is represented by 20
        if mode == "temporal":
            kw_j["prev_island_frame"] = jnp.int32(prev)
            kw_t["prev_island_frame"] = prev
        ref = jl.detect(jd, *jq, jnp.float32(0.6), params, **kw_j)
        got = tl.detect(td, *tq, 0.6, tl.LcdParams(*params), **kw_t)
        assert int(got.match_id) == int(ref.match_id)
        assert bool(got.detected) == bool(ref.detected)
        np.testing.assert_allclose(float(got.island_score),
                                   float(ref.island_score), rtol=1e-6)
        np.testing.assert_allclose(float(got.best_score),
                                   float(ref.best_score), rtol=1e-6)
        results.append(bool(got.detected))
    if mode == "temporal":  # no history, close, far
        assert results == [False, True, False]
    else:
        assert all(results)
