"""`kimera_multi_tpu_torch.entry.entry(device="cpu")` against the JAX
package's `__graft_entry__.entry()`: the fused SLAM step (loop-closure
verification, then one lifted-RBCD round) on the same inputs.

Tolerances: the verification inputs are equal and Y0 within 2e-6 (the
lifting matrix's normal draws, tests/test_torch_stiefel.py); after the
round Y within 1e-5 and the cost within 1e-5 relative
(tests/test_torch_rbcd.py); the stereo pose within 1e-5 (a weighted Arun
refit over 64 points); gates and stereo inlier counts exactly. The mono
inlier count is taken after the weighted 8-point refit, whose float32
normal matrix is ill-conditioned on noise-free bearings (ROADMAP Queue 3:
here 39 / 43 / 41 / 34 in the JAX package against 36 / 39 / 43 / 36), so
only the gate it decides (`lc_ok`, at least 10) is compared."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from kimera_multi_tpu_torch import entry as tentry
from kimera_multi_tpu_torch.io import synthetic
from kimera_multi_tpu_torch.kernels import gather, hamming, score
from kimera_multi_tpu_torch.solve import rbcd

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    fj, aj = jentry.entry()
    want = {k: np.asarray(v) for k, v in jax.jit(fj)(*aj).items()}
    f, a = tentry.entry(device="cpu")
    return aj, want, a, f


def test_entry_matches_jax(both):
    aj, want, a, f = both
    assert len(a) == len(aj) == 8
    np.testing.assert_allclose(a[0].numpy(), np.asarray(aj[0]), rtol=0,
                               atol=2e-6)
    for x, y in zip(a[1:], aj[1:]):
        assert np.array_equal(x.numpy(), np.asarray(y))
    out = f(*a)
    assert set(out) == set(want)
    got = {k: v.numpy() for k, v in out.items()}
    for k in ("lc_ok", "stereo_inliers"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["lc_ok"].all() and (got["mono_inliers"] >= 10).all()
    assert got["Y"].shape == (2, 16, 5, 4)
    np.testing.assert_allclose(got["Y"], want["Y"], rtol=0, atol=1e-5)
    assert abs(float(got["cost"]) - float(want["cost"])) \
        <= 1e-5 * float(want["cost"])
    np.testing.assert_allclose(got["lc_R"], want["lc_R"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["lc_t"], want["lc_t"], rtol=0, atol=1e-5)
    # the round lowers the lifted cost from Y0's
    g = synthetic.multi_robot_graph(seed=0, n_robots=2, n_poses=16,
                                    outlier_ratio=0.2, n_intra_lc=3,
                                    n_inter_lc=4, device="cpu")
    c0 = rbcd.lifted_cost(a[0].reshape(-1, 5, 4), g.edges,
                          torch.ones(g.edges.capacity), 16)
    assert float(out["cost"]) < 0.01 * float(c0)


def test_step_takes_the_kernel_wrappers(both, monkeypatch):
    """The step calls the wrappers that launch K1, K4 (twice a gate), K8
    and K9 on the card; on the CPU they take their plain versions."""
    _, _, a, f = both
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((hamming, "knn2_lowe_match_pairs"),
                      (gather, "sample_gather_perm_t"),
                      (score, "rigid_counts"), (score, "essential_counts")):
        spy(mod, name)
    f(*a)
    assert calls == {"knn2_lowe_match_pairs": 1, "sample_gather_perm_t": 4,
                     "rigid_counts": 1, "essential_counts": 1}


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        _, a = tentry.entry()
        assert all(x.device.type == "cuda" for x in a)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tentry.entry()
