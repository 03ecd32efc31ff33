"""The port's 5-point mono RANSAC (`ransac.ransac_essential_5pt`) and the
default verifier (`make_verifier(FrontendConfig())`, use_5pt=True) against
the JAX package's, under the same threefry keys, on shared numpy inputs.
On the CPU the port takes the plain versions of its CUDA kernels.

Both packages draw the same sample tables (threefry is bit-equal), but the
5-point polish is a root finder whose float32 rounding differs between the
packages (tests/test_torch_fivept.py), so a hypothesis can polish into
another root on one side. Compared: the gate (`ok`) exactly and the inlier
recall of the clean correspondences within 0.02,
at K = 160 (the preselect branch) and K = 96 (the exhaustive branch); on
the verifier, both gates and the stereo inlier counts exactly and the
pose within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import rng as jrng
from kimera_multi_tpu.frontend import batched as jbatched, dlc as jdlc
from kimera_multi_tpu.kernels import ransac as jr
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import rng as trng
from kimera_multi_tpu_torch.frontend import batched as tbatched
from kimera_multi_tpu_torch.io import synthetic
from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import ransac as tr

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

N_HYP = 500
SEEDS = np.arange(4)


def _problem(seed, outlier_ratio, K):
    """The fixture of tests/test_mono_5pt_parity.py: K noise-free bearing
    pairs of one rigid scene, `outlier_ratio` of them with shuffled
    associations. Returns f1, f2 (3, K) SoA and the clean mask."""
    npr = np.random.default_rng(seed)
    P = npr.uniform(-3, 3, (K, 3)).astype(np.float32)
    P[:, 2] = npr.uniform(4, 10, K)
    R = _so3_exp_np(npr.normal(0, 0.3, 3).astype(np.float32))
    t = npr.uniform(-1, 1, 3).astype(np.float32)
    P2 = (P - t[None]) @ R  # R^T (P - t)
    f1 = P / np.linalg.norm(P, axis=1, keepdims=True)
    f2 = P2 / np.linalg.norm(P2, axis=1, keepdims=True)
    is_out = npr.uniform(size=K) < outlier_ratio
    idx = np.nonzero(is_out)[0]
    f2[idx] = f2[npr.permutation(idx)]  # shuffled associations
    return (np.ascontiguousarray(f1.T, np.float32),
            np.ascontiguousarray(f2.T, np.float32), ~is_out)


@pytest.fixture(scope="module")
def jax_5pt():
    """The JAX function, jitted once for the module (one compile per K)."""
    return jax.jit(lambda k, a, b, v: jr.ransac_essential_5pt(
        k, a, b, v, n_hyp=N_HYP, min_inliers=10))


@pytest.mark.parametrize("K,outlier_ratio", [(160, 0.5), (160, 0.6),
                                             (96, 0.5)])
def test_ransac_essential_5pt_matches_jax(jax_5pt, K, outlier_ratio):
    probs = [_problem(1000 + int(s), outlier_ratio, K) for s in SEEDS]
    f1 = np.stack([p[0] for p in probs])
    f2 = np.stack([p[1] for p in probs])
    clean = np.stack([p[2] for p in probs])
    valid = np.ones((len(SEEDS), K), bool)
    kt = trng.derive(trng.base_key(0), torch.from_numpy(SEEDS))
    res = tr.ransac_essential_5pt(kt, torch.from_numpy(f1),
                                  torch.from_numpy(f2),
                                  torch.from_numpy(valid), n_hyp=N_HYP,
                                  min_inliers=10)
    assert res["E"].shape == (len(SEEDS), 3, 3)
    assert res["n_inliers"].dtype == torch.int32
    for c, s in enumerate(SEEDS):
        ref = jax_5pt(jrng.derive(jrng.base_key(0), int(s)),
                      jnp.asarray(f1[c]), jnp.asarray(f2[c]),
                      jnp.asarray(valid[c]))
        inl_j = np.asarray(ref["inliers"])
        inl_t = res["inliers"][c].numpy()
        assert bool(ref["ok"]) == bool(res["ok"][c])
        rec_j = inl_j[clean[c]].mean()
        rec_t = inl_t[clean[c]].mean()
        assert abs(rec_j - rec_t) <= 0.02, (s, rec_j, rec_t)
        assert int(res["n_inliers"][c]) == inl_t.sum()
    # and it works: at 50 % outliers every problem is solved
    if outlier_ratio == 0.5:
        assert res["ok"].all()
        assert (res["inliers"].numpy()[clean]).mean() > 0.9


def test_injected_draws_equal_keyed_draws_5pt():
    """`u=` replaces the keyed draws: same table, same result."""
    K = 96
    f1, f2, _ = _problem(7, 0.3, K)
    f1, f2 = (torch.from_numpy(np.stack([x, x])) for x in (f1, f2))
    valid = torch.ones(2, K, dtype=torch.bool)
    kt = trng.derive(trng.base_key(5), torch.arange(2))
    u = trng.uniform(kt, (64, 5))
    a = tr.ransac_essential_5pt(kt, f1, f2, valid, n_hyp=64)
    b = tr.ransac_essential_5pt(None, f1, f2, valid, n_hyp=64, u=u)
    for k in ("E", "inliers", "n_inliers", "ok"):
        assert torch.equal(a[k], b[k]), k


def test_default_verifier_matches_jax():
    """make_verifier(FrontendConfig()) — the default 5-point gate — of
    the port against the JAX package's on small stores, with the preselect
    branch active (K = 160 > 2 x 64, 200 hypotheses > 128)."""
    S = synthetic.make_stores_np(2, 4, 160, seed=2, invalid_tail=3)
    jcfg = jdlc.FrontendConfig(ransac_hyp=200)
    assert jcfg.use_5pt
    key = jrng.base_key(4)
    ref = jbatched.make_verifier(jcfg)(
        key, *(jnp.asarray(x) for x in (S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, S.qr, S.qf, S.tr, S.tm)))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    tcfg = convert.config_from_jax(jcfg)
    assert tcfg.use_5pt and tcfg.ransac_hyp == 200
    tkey = convert.key_from_jax_key_data(np.asarray(jax.random.key_data(key)))
    tstores = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, device="cpu")
    out = tbatched.make_verifier(tcfg, device="cpu")(
        tkey, *tstores, S.qr, S.qf, S.tr, S.tm)
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("mono_ok", "stereo_ok", "stereo_inliers"):
        np.testing.assert_array_equal(ref[k], out[k], err_msg=k)
    np.testing.assert_allclose(ref["R"], out["R"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref["t"], out["t"], rtol=1e-4, atol=1e-4)
    true = S.is_true
    assert out["mono_ok"][true].all() and out["stereo_ok"][true].all()
    assert not (out["mono_ok"][~true] | out["stereo_ok"][~true]).any()
