"""The verification path as a whole:
`make_verifier(FrontendConfig(use_5pt=False))` of the port against the
JAX package's, on stores made by `io.synthetic.make_stores_np` and
carried across by `convert`, with the same base key. Both run on the CPU; the port takes the plain versions of
its CUDA kernels there.

Tolerances: gates and inlier counts are integers and compared exactly;
R, t at 1e-4 (they come from the stereo consensus refit over hundreds of
points, well conditioned). The mono inlier count is taken after the
weighted 8-point refit, whose float32 normal matrix on these noise-free,
narrow-field bearings has an eigen-gap of 1e-4 of its largest eigenvalue:
both packages land within 1e-3 of the true E and of each other, which at
the default threshold of 1e-6 (a residual of 1e-3) moves points across
the threshold. So the count is compared exactly at a threshold of 1e-4,
and at the default threshold only the gate is."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import rng as jrng
from kimera_multi_tpu.frontend import batched as jbatched, dlc as jdlc
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import backend
from kimera_multi_tpu_torch.frontend import batched as tbatched, dlc as tdlc
from kimera_multi_tpu_torch.io import synthetic
from kimera_multi_tpu_torch.kernels import ransac as tr

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HYP = 64


@pytest.fixture(scope="module")
def stores():
    return synthetic.make_stores_np(2, 6, 96, seed=1, invalid_tail=3)


def _run_both(S, mono_threshold, seed=3):
    jcfg = jdlc.FrontendConfig(use_5pt=False, ransac_hyp=N_HYP,
                               mono_threshold=mono_threshold)
    key = jrng.base_key(seed)
    ref = jbatched.make_verifier(jcfg)(
        key, *(jnp.asarray(x) for x in (S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, S.qr, S.qf, S.tr, S.tm)))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    # state carried across as numpy arrays and plain values
    tcfg = convert.config_from_jax(jcfg)
    tkey = convert.key_from_jax_key_data(np.asarray(jax.random.key_data(key)))
    tstores = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, device="cpu")
    out = tbatched.make_verifier(tcfg, device="cpu")(
        tkey, *tstores, S.qr, S.qf, S.tr, S.tm)
    return ref, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("mono_threshold", [1e-6, 1e-4])
def test_verify_many_matches_jax(stores, mono_threshold):
    S = stores
    ref, out = _run_both(S, mono_threshold)
    assert set(ref) == set(out)
    for k in ("mono_ok", "stereo_ok", "stereo_inliers"):
        np.testing.assert_array_equal(ref[k], out[k], err_msg=k)
    if mono_threshold == 1e-4:
        np.testing.assert_array_equal(ref["mono_inliers"],
                                      out["mono_inliers"])
    np.testing.assert_allclose(ref["R"], out["R"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref["t"], out["t"], rtol=1e-4, atol=1e-4)
    assert out["mono_inliers"].dtype == np.int32
    # and it is right: true pairs accepted at the generator's pose,
    # pairs of unrelated frames rejected
    true = S.is_true
    assert out["mono_ok"][true].all() and out["stereo_ok"][true].all()
    assert not (out["mono_ok"][~true] | out["stereo_ok"][~true]).any()
    np.testing.assert_allclose(out["R"][true], S.R_gt[true], atol=1e-3)
    np.testing.assert_allclose(out["t"][true], S.t_gt[true], atol=1e-3)


def test_results_do_not_depend_on_batching(stores):
    """Draws are keyed per candidate, so a candidate verified alone gives
    what it gives inside a chunk."""
    S = stores
    tstores = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, device="cpu")
    verify = tbatched.make_verifier(
        tdlc.FrontendConfig(use_5pt=False, ransac_hyp=N_HYP), device="cpu")
    from kimera_multi_tpu_torch.core import rng as trng
    key = trng.base_key(9)
    full = verify(key, *tstores, S.qr, S.qf, S.tr, S.tm)
    sel = np.array([4, 1, 7])
    part = verify(key, *tstores, S.qr[sel], S.qf[sel], S.tr[sel], S.tm[sel])
    for k in ("mono_ok", "stereo_ok", "stereo_inliers"):
        np.testing.assert_array_equal(full[k].numpy()[sel], part[k].numpy())
    np.testing.assert_allclose(full["R"].numpy()[sel], part["R"].numpy(),
                               atol=1e-5)


def test_use_5pt_raises():
    """use_5pt=True is the default, as in the JAX package, and the 5-point
    gate raises only on a setting it cannot run: more starts than its start
    table holds (tests/test_torch_ransac5.py holds the gate itself against
    the JAX package)."""
    assert tdlc.FrontendConfig().use_5pt is True
    assert tdlc.FrontendConfig._fields == jdlc.FrontendConfig._fields
    f = torch.nn.functional.normalize(torch.rand(1, 3, 12), dim=1)
    valid = torch.ones(1, 12, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_starts"):
        tr.ransac_essential_5pt(None, f, f, valid, n_hyp=4, n_starts=17,
                                u=torch.rand(1, 4, 5))


def test_asking_for_a_missing_card_raises():
    if torch.cuda.is_available():
        assert backend.default_device().type == "cuda"
        assert backend.kernel_path() == "cuda"
        return
    assert backend.kernel_path() == "torch"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatched.make_verifier(tdlc.FrontendConfig(use_5pt=False))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.default_device()


def test_store_on_wrong_device_raises(stores):
    S = stores
    tstores = convert.stores_from_numpy(S.desc, S.obs_valid, S.bearings,
                                        S.landmarks, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        convert.stores_from_numpy(S.desc, S.obs_valid[..., :5], S.bearings,
                                  S.landmarks, device="cpu")
    verify = tbatched.make_verifier(tdlc.FrontendConfig(use_5pt=False),
                                    device="cpu")
    meta = [t.to("meta") for t in tstores]
    from kimera_multi_tpu_torch.core import rng as trng
    with pytest.raises(ValueError, match="lies on"):
        verify(trng.base_key(0), *meta, S.qr, S.qf, S.tr, S.tm)


def test_make_stores_layout():
    S = synthetic.make_stores_np(3, 4, 40, seed=0, n_false=2)
    assert S.desc.shape == (3, 4, 40, 32) and S.desc.dtype == np.uint8
    assert S.obs_valid.shape == (3, 4, 40)
    assert S.bearings.shape == S.landmarks.shape == (3, 4, 3, 40)
    assert len(S.qr) == 6 + 2 and S.is_true.sum() == 6
    # landmarks of a true pair are related by the ground-truth pose
    c = 4
    pa = S.landmarks[S.qr[c], S.qf[c]]
    pb = S.landmarks[S.tr[c], S.tm[c]]
    np.testing.assert_allclose(S.R_gt[c] @ pb + S.t_gt[c][:, None], pa,
                               atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(S.bearings, axis=2), 1.0,
                               atol=1e-5)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package — by source and in a fresh interpreter."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "kimera_multi_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "kimera_multi_tpu"), \
                f"{path} imports {mod}"
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import kimera_multi_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = [m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kimera_multi_tpu')]\n"
        "assert not bad, bad\n"
        "for m in ('kernels.ransac', 'kernels.bow', 'frontend.bow_db',\n"
        "          'frontend.lcd', 'frontend.vocab', 'io.sim_world',\n"
        "          'core.containers', 'core.lie', 'core.stiefel',\n"
        "          'io.synthetic', 'solve.pgo', 'solve.rbcd',\n"
        "          'solve.gnc', 'entry', 'solve.pcm', 'solve.robust',\n"
        "          'solve.chordal', 'solve.incidence', 'frontend.submap',\n"
        "          'eval.ape', 'io.logs', 'cli.run', 'io.render',\n"
        "          'io.config', 'vio._sample', 'vio.undistort',\n"
        "          'vio.tracking', 'vio.descriptors', 'vio.imu',\n"
        "          'vio.smoother', 'vio.pipeline', 'io.dataset',\n"
        "          'io.rosbag', 'io.png', 'io.replay', 'io.convert',\n"
        "          'io.record', 'cli.replay'):\n"
        "    assert 'kimera_multi_tpu_torch.' + m in new, m\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
