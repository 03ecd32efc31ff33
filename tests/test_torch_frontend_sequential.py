"""The port's sequential front-end (`frontend/dlc.py::DistributedFrontend`,
`cli/run.py --frontend sequential`) and world-frame correction
(`frontend/tf_correction.py`) on the CPU, on tests/test_frontend_batched.py's
fixture (make_world(2, 30, 64, seed=1), a k = 8, depth 3 vocabulary,
base_seed 1).

Tolerances: against the port's batched front-end, exact: every attempt's
keys, status, acceptance, inlier counts, BoW score and R, t bit for bit,
with min_temporal_matches 1 and 2. Against the JAX package's
`DistributedFrontend`, as tests/test_torch_frontend_batched.py compares
the batched ones: keys, status, acceptance and stereo counts exactly,
BoW scores within 1e-5 relative, R, t of accepted loops within 1e-4, mono
counts equal on all but 2 candidates and within 2 there (the weighted
8-point refit, ROADMAP Queue 3). `tf_correction` as
tests/test_frontend.py::test_tf_correction (1e-5 / 1e-4)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.frontend import dlc as jd, vocab as jv
from kimera_multi_tpu.io import sim_world as jw
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.frontend import batched as tb, dlc, tf_correction
from kimera_multi_tpu_torch.frontend import vocab as tv
from kimera_multi_tpu_torch.frontend.lcd import LcdParams
from kimera_multi_tpu_torch.io import sim_world

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    w = jw.make_world(n_robots=2, n_steps=30, features_per_kf=64, seed=1)
    corpus = w.descriptors[w.obs_valid].reshape(-1, 32)
    return w, corpus[:: max(1, len(corpus) // 4000)]


def _run(fe, w):
    return fe.process_all(w.descriptors, w.bearings_local, w.landmarks_local,
                          w.obs_valid)


def _row(lc):
    return (lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b, lc.status,
            lc.accepted, lc.mono_inliers, lc.stereo_inliers, lc.bow_score,
            np.asarray(lc.R).tobytes(), np.asarray(lc.t).tobytes())


@pytest.mark.parametrize("min_temporal", [1, 2])
def test_sequential_equals_batched(world, min_temporal):
    w, sub = world
    voc = tv.build_vocabulary(sub, 8, 3, seed=1, device="cpu")
    cfg = dlc.FrontendConfig(base_seed=1,
                             lcd=LcdParams(min_temporal_matches=min_temporal))
    bat = tb.BatchedFrontend(2, 30, voc, cfg, device="cpu")
    _run(bat, w)
    seq = dlc.DistributedFrontend(2, 30, voc, cfg, device="cpu")
    stats = _run(seq, w)
    assert stats["n_keyframes"] == 60
    assert stats["n_candidates"] == len(bat.lcd_attempts) > 10
    assert [_row(a) for a in seq.lcd_attempts] \
        == [_row(a) for a in bat.lcd_attempts]
    assert [_row(a) for a in seq.loops] == [_row(a) for a in bat.loops]
    assert seq.bow_overflow == bat.bow_overflow
    e, eb = (f.build_pose_graph(w.R_odo, w.t_odo) for f in (seq, bat))
    assert all(torch.equal(getattr(e, f), getattr(eb, f))
               for f in ("src_robot", "src_pose", "dst_robot", "dst_pose",
                         "R", "t", "kappa", "tau", "etype"))


def test_sequential_matches_jax(world):
    w, sub = world
    jcfg = jd.FrontendConfig(base_seed=1)
    ref = jd.DistributedFrontend(2, 30, jv.build_vocabulary(sub, 8, 3,
                                                            seed=1), jcfg)
    for k in range(30):
        for r in range(2):
            if w.obs_valid[r, k].any():
                ref.process_keyframe(r, k, w.descriptors[r, k],
                                     w.bearings_local[r, k],
                                     w.landmarks_local[r, k],
                                     w.obs_valid[r, k])
    voc = tv.build_vocabulary(sub, 8, 3, seed=1, device="cpu")
    got = dlc.DistributedFrontend(2, 30, voc, convert.config_from_jax(jcfg),
                                  device="cpu")
    _run(got, w)
    key = lambda lc: (lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b,  # noqa
                      lc.status, lc.accepted, lc.stereo_inliers)
    assert [key(a) for a in got.lcd_attempts] \
        == [key(a) for a in ref.lcd_attempts]
    assert len(got.lcd_attempts) > 10 and len(got.loops) > 5
    mono = np.asarray([a.mono_inliers for a in got.lcd_attempts])
    mono_j = np.asarray([a.mono_inliers for a in ref.lcd_attempts])
    assert (mono != mono_j).sum() <= 2 and np.abs(mono - mono_j).max() <= 2
    for a, b in zip(got.lcd_attempts, ref.lcd_attempts):
        assert abs(a.bow_score - b.bow_score) <= 1e-5 * abs(b.bow_score)
    for a, b in zip(got.loops, ref.loops):
        np.testing.assert_allclose(a.R, np.asarray(b.R), atol=1e-4)
        np.testing.assert_allclose(a.t, np.asarray(b.t), atol=1e-4)
    assert got.bow_overflow == ref.bow_overflow


def test_cli_frontend_sequential(world, tmp_path):
    """`--frontend sequential` runs the `sim` mode end to end and commits
    the batched run's loops on the port's own world (the CLI builds its
    vocabulary and keys from --seed)."""
    sub = world[1]
    w = sim_world.make_world(n_robots=2, n_steps=30, features_per_kf=64,
                             seed=1)
    out = run.main(["--mode", "sim", "--robots", "2", "--steps", "30",
                    "--features", "64", "--seed", "1", "--gnc-rounds", "12",
                    "--device", "cpu", "--frontend", "sequential",
                    "--log-dir", str(tmp_path)])
    bat = tb.BatchedFrontend(2, 30, tv.build_vocabulary(sub, 8, 3, seed=1,
                                                        device="cpu"),
                             dlc.FrontendConfig(base_seed=1), device="cpu")
    _run(bat, w)
    assert [_row(a) for a in out["loops"]] == [_row(a) for a in bat.loops]
    assert out["frontend"]["n_candidates"] == len(bat.lcd_attempts)
    for r in range(2):
        assert out["ape"][r].rmse_trans < 0.15
        assert glob.glob(os.path.join(str(tmp_path), f"robot{r}",
                                      "distributed", "loop_closures.csv"))


def test_tf_correction():
    rng = np.random.default_rng(12)
    w = rng.normal(0, 0.5, (4, 3)).astype(np.float32)
    R_odom = lie.so3_exp(torch.from_numpy(w))
    t_odom = torch.from_numpy(rng.normal(0, 2, (4, 3)).astype(np.float32))
    # world = a fixed transform of odom
    Rg = lie.so3_exp(torch.tensor([0.3, -0.1, 0.8]))
    tg = torch.tensor([5.0, 1.0, -2.0])
    R_world = torch.einsum("ij,kjl->kil", Rg, R_odom)
    t_world = torch.einsum("ij,kj->ki", Rg, t_odom) + tg
    corr = tf_correction.world_to_odom_correction(R_odom[2], t_odom[2],
                                                  R_world[2], t_world[2])
    Rc, tc = tf_correction.apply_correction(corr, R_odom, t_odom)
    assert torch.allclose(Rc, R_world, atol=1e-5)
    assert torch.allclose(tc, t_world, atol=1e-4)
    # against the JAX package's on the same inputs
    from kimera_multi_tpu.frontend import tf_correction as jtf

    cj = jtf.world_to_odom_correction(
        *(jnp.asarray(x.numpy()) for x in (R_odom[2], t_odom[2],
                                           R_world[2], t_world[2])))
    Rj, tj = jtf.apply_correction(cj, jnp.asarray(R_odom.numpy()),
                                  jnp.asarray(t_odom.numpy()))
    np.testing.assert_allclose(Rc.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(tj), atol=1e-5)
