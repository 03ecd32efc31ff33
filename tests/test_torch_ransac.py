"""The port's batched RANSAC (kernels/ransac.py) against the JAX package's
per-candidate functions under the same threefry keys, on shared numpy
inputs. On the CPU the port's gathers and counts take the plain versions
of their CUDA kernels.

Tolerances: sample tables (picks, order, inv_order) are integers and must
be equal. With the same table both sides score the same hypotheses, so the
inlier masks, counts and gates are compared exactly on data with a clear
margin around the thresholds; R, t, E at 1e-4 (E up to sign): they come
out of the consensus refits, whose eigenvector problems amplify float32
rounding (see test_torch_soa_minimal.py), on bearings spread over the
sphere with 3e-4 rad of noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import rng as jrng
from kimera_multi_tpu.kernels import ransac as jr
from kimera_multi_tpu_torch.core import rng as trng
from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import ransac as tr, score as ts

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

C, K, H = 4, 80, 48
# squared Sampson threshold of the mono tests: the 3e-4 rad bearing noise
# puts inliers near 1e-7, so 1e-5 keeps every inlier a factor ~100 (and the
# gross outliers many orders) away from the threshold
THR_MONO = 1e-5


def _keys(seed, stream):
    ids = np.arange(C) + 10
    kj = [jrng.derive(jrng.base_key(seed), int(i), stream) for i in ids]
    kt = trng.derive(trng.base_key(seed), torch.from_numpy(ids), int(stream))
    return kj, kt


def _masks(kind, seed=0):
    rs = np.random.default_rng(seed)
    if kind == "many":
        return rs.uniform(size=(C, K)) < 0.9
    if kind == "few":
        return rs.uniform(size=(C, K)) < 0.15
    v = np.zeros((C, K), bool)        # "starved": fewer valid than k
    v[0, [3, 40]] = True
    v[1, 7] = True
    v[3, :] = True
    return v


@pytest.mark.parametrize("kind", ["many", "few", "starved"])
@pytest.mark.parametrize("k", [3, 8, 5])
def test_masked_sample_parts(kind, k):
    valid = _masks(kind)
    kj, kt = _keys(1, jrng.Stream.RANSAC_MONO)
    picks, order, inv = tr._masked_sample_parts(kt, torch.from_numpy(valid),
                                                H, k)
    assert picks.dtype == order.dtype == inv.dtype == torch.int32
    for c in range(C):
        pj, oj, ij = jr._masked_sample_parts(kj[c], jnp.asarray(valid[c]),
                                             H, k)
        np.testing.assert_array_equal(np.asarray(pj), picks[c].numpy())
        np.testing.assert_array_equal(np.asarray(oj), order[c].numpy())
        np.testing.assert_array_equal(np.asarray(ij), inv[c].numpy())
        np.testing.assert_array_equal(
            np.asarray(jr._distinct(pj)), tr._distinct(picks[c]).numpy())
    if kind == "many":   # enough valid entries: samples are distinct valid
        idx = torch.gather(order.long(), 1, picks.reshape(C, -1).long())
        assert torch.gather(torch.from_numpy(valid), 1, idx).all()
        assert tr._distinct(picks).all()


def test_injected_draws_equal_keyed_draws():
    valid = _masks("many", 2)
    kj, kt = _keys(2, jrng.Stream.RANSAC_STEREO)
    u = np.stack([np.asarray(jax.random.uniform(k, (H, 3))) for k in kj])
    a = tr._masked_sample_parts(kt, torch.from_numpy(valid), H, 3)
    b = tr._masked_sample_parts(None, torch.from_numpy(valid), H, 3,
                                u=torch.from_numpy(u))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_first_argmax_takes_first_of_ties():
    x = torch.tensor([[1, 5, 5, 2], [0, 0, 0, 0], [3, 1, 3, 9]])
    assert ts.first_argmax(x).tolist() == [1, 0, 3]
    np.testing.assert_array_equal(ts.first_argmax(x).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(
                                      x.numpy()), axis=1)))


def _scene(seed, out_frac=0.35):
    """Two views of a cloud all around the cameras; `out_frac` of the
    correspondences are gross outliers, some entries invalid."""
    rs = np.random.default_rng(seed)
    P = rs.uniform(-6, 6, (C, 3, K))
    R = _so3_exp_np(rs.normal(0, 0.4, (C, 3))).astype(np.float64)
    t = rs.uniform(-1, 1, (C, 3))
    Pb = np.einsum("cji,cjk->cik", R, P - t[:, :, None])
    out = rs.uniform(size=(C, K)) < out_frac
    Pb = np.where(out[:, None, :], rs.uniform(-6, 6, (C, 3, K)), Pb)

    def bearings(X):
        f = X / np.linalg.norm(X, axis=1, keepdims=True)
        f = f + rs.normal(0, 3e-4, f.shape)
        return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(
            np.float32)

    valid = rs.uniform(size=(C, K)) < 0.9
    return (P.astype(np.float32), Pb.astype(np.float32), bearings(P),
            bearings(Pb), valid, out)


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_arun(seed):
    P, Pb, _, _, valid, out = _scene(seed)
    kj, kt = _keys(seed, jrng.Stream.RANSAC_STEREO)
    res = tr.ransac_arun(kt, torch.from_numpy(P), torch.from_numpy(Pb),
                         torch.from_numpy(valid), threshold=0.3, n_hyp=H,
                         min_inliers=5)
    for c in range(C):
        ref = jr.ransac_arun(kj[c], jnp.asarray(P[c]), jnp.asarray(Pb[c]),
                             jnp.asarray(valid[c]), threshold=0.3, n_hyp=H,
                             min_inliers=5)
        np.testing.assert_array_equal(np.asarray(ref["inliers"]),
                                      res["inliers"][c].numpy())
        assert int(ref["n_inliers"]) == int(res["n_inliers"][c])
        assert bool(ref["ok"]) == bool(res["ok"][c]) is True
        np.testing.assert_allclose(np.asarray(ref["R"]), res["R"][c].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(ref["t"]), res["t"][c].numpy(),
                                   rtol=1e-4, atol=1e-4)
        # consensus = the uncorrupted valid correspondences
        np.testing.assert_array_equal(res["inliers"][c].numpy(),
                                      valid[c] & ~out[c])


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_essential(seed):
    # 10% outliers: 43% of the 8-point samples are outlier-free
    _, _, f1, f2, valid, out = _scene(seed, out_frac=0.1)
    kj, kt = _keys(seed, jrng.Stream.RANSAC_MONO)
    res = tr.ransac_essential(kt, torch.from_numpy(f1), torch.from_numpy(f2),
                              torch.from_numpy(valid), threshold=THR_MONO,
                              n_hyp=H, min_inliers=10)
    for c in range(C):
        ref = jr.ransac_essential(kj[c], jnp.asarray(f1[c]),
                                  jnp.asarray(f2[c]), jnp.asarray(valid[c]),
                                  threshold=THR_MONO, n_hyp=H, min_inliers=10)
        np.testing.assert_array_equal(np.asarray(ref["inliers"]),
                                      res["inliers"][c].numpy())
        assert int(ref["n_inliers"]) == int(res["n_inliers"][c])
        assert bool(ref["ok"]) == bool(res["ok"][c]) is True
        Ej, Et = np.asarray(ref["E"]), res["E"][c].numpy()
        np.testing.assert_allclose(Ej, np.sign(np.sum(Ej * Et)) * Et,
                                   rtol=1e-4, atol=1e-4)
        assert (res["inliers"][c].numpy() & out[c]).sum() <= 1
        assert int(res["n_inliers"][c]) >= 0.9 * (valid[c] & ~out[c]).sum()


def test_ransac_rejects_when_nothing_is_valid():
    """No valid correspondence: both gates close, and the degenerate
    models that come back (NaN entries included) are the reference's."""
    P, Pb, f1, f2, valid, _ = _scene(3)
    none = torch.zeros(C, K, dtype=torch.bool)
    kj, kt = _keys(3, jrng.Stream.RANSAC_STEREO)
    st = tr.ransac_arun(kt, torch.from_numpy(P), torch.from_numpy(Pb), none,
                        n_hyp=H)
    mono = tr.ransac_essential(kt, torch.from_numpy(f1), torch.from_numpy(f2),
                               none, n_hyp=H)
    for r in (st, mono):
        assert not r["ok"].any() and (r["n_inliers"] == 0).all()
        assert not r["inliers"].any()
    rj = jr.ransac_arun(kj[0], jnp.asarray(P[0]), jnp.asarray(Pb[0]),
                        jnp.zeros(K, bool), n_hyp=H)
    mj = jr.ransac_essential(kj[0], jnp.asarray(f1[0]), jnp.asarray(f2[0]),
                             jnp.zeros(K, bool), n_hyp=H)
    np.testing.assert_allclose(np.asarray(rj["R"]), st["R"][0].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(rj["t"]), st["t"][0].numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(np.isnan(np.asarray(mj["E"])),
                                  torch.isnan(mono["E"][0]).numpy())
