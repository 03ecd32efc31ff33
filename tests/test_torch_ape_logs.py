"""The port's APE (`eval/ape.py`) and reference-schema logs (`io/logs.py`)
against the JAX package's, on the CPU, on tests/test_eval_io.py's cases:
headers equal the JAX constants and the writers write the same bytes; a
TUM file round-trips; APE of an identical, a rigidly moved and a
corrupted copy, timestamp association and the file-level `ape_from_tum`
agree with JAX.

Tolerances: bytes and association equal; APE values within 1e-5
relative plus 5e-5 absolute for translations and 1e-4 for the full
metric: float32 alignment of positions up to 6 m through the closed-form
3 x 3 eigendecomposition of `so3_procrustes` in both packages, summed in
other orders, leaves each package 1e-6 - 2e-5 m and up to 1e-4 in
rotation from zero on an exact copy (tests/test_eval_io.py's own bounds
there are 1e-5 and 1e-4); and those bounds. The Sim(3) alignment's
rotation within 1e-4, its translation within 5e-4 (that rotation noise
times centroids up to 5 m), its scale within 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import lie as jlie
from kimera_multi_tpu.eval import ape as jape
from kimera_multi_tpu.io import logs as jlogs
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.eval import ape
from kimera_multi_tpu_torch.io import logs

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

HEADERS = ("LOOP_CLOSURES_HEADER", "KEYFRAMES_HEADER", "LCD_STATUS_HEADER",
           "LCD_RESULT_HEADER", "LCD_ATTEMPTS_HEADER", "DPGO_LOG_HEADER")


def _traj(n, seed=0, offset=0.0):
    """tests/test_eval_io.py's trajectory."""
    npr = np.random.default_rng(seed)
    ts = np.arange(n) * 0.05 + offset
    t = np.cumsum(npr.normal(0, 0.1, (n, 3)), axis=0).astype(np.float32)
    w = npr.normal(0, 0.2, (n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    q = np.asarray(jlie.rot_to_quat(jnp.asarray(R)))
    return ts, t, R, q


def _close(got, want):
    for f, atol in (("rmse_trans", 5e-5), ("mean_trans", 5e-5),
                    ("max_trans", 5e-5), ("rmse_full", 1e-4)):
        a, b = getattr(got, f), getattr(want, f)
        assert isinstance(a, float) and abs(a - b) <= atol + 1e-5 * abs(b), f
    assert got.n_matched == want.n_matched


def test_headers_and_writers_match_jax(tmp_path):
    for h in HEADERS:
        assert getattr(logs, h) == getattr(jlogs, h), h
    rows = {
        "loop_closures": [dict(
            robot1=0, pose1=5, robot2=1, pose2=9, qx=0.0, qy=0.0, qz=0.0,
            qw=1.0, tx=1.5, ty=0.0, tz=-0.25, norm_bow_score=0.31,
            mono_inliers=np.int32(22), stereo_inliers=11,
            stamp_ns=123456789)],
        "keyframes": [dict(keyframe_id=k, keyframe_stamp_ns=k * 500000000,
                           tx=np.float32(0.1) * k, ty=-1.0, tz=2.5e-9,
                           qx=0.0, qy=0.0, qz=0.0, qw=1.0)
                      for k in range(3)],
        "lcd_status": [dict(lcd_status="LOOP_DETECTED", query_id=29,
                            match_id=0, mono_inliers=17,
                            stereo_inliers=64)],
        "lcd_result": [dict(isLoop=True, queryKfId=3, matchKfId=1,
                            timestamp_query=1.5, timestamp_match=0.5, x=1.0,
                            y=2.0, z=3.0, qx=0.0, qy=0.0, qz=0.0, qw=1.0)],
        "lcd_attempts": [dict(robot_a=1, frame_a=2, robot_b=0, frame_b=1,
                              lcd_status="FAILED_GEOM_VERIFICATION",
                              mono_inliers=0, stereo_inliers=0,
                              norm_bow_score=6.744965076446533)],
        "dpgo_log": [dict(robot_id=0, instance=0, iteration=0,
                          num_poses=60, total_time_sec=1.25,
                          num_active_robots=2)],
    }
    for name, rr in rows.items():
        fn = f"write_{name}_csv"
        a, b = str(tmp_path / f"a_{name}.csv"), str(tmp_path / f"b_{name}.csv")
        getattr(logs, fn)(a, rr)
        getattr(jlogs, fn)(b, rr)
        assert open(a).read() == open(b).read(), name
        cols = logs.read_csv(a)
        assert list(cols) == list(jlogs.read_csv(b))
    cols = logs.read_csv(str(tmp_path / "a_loop_closures.csv"))
    assert cols["mono_inliers"][0] == 22
    assert abs(cols["norm_bow_score"][0] - 0.31) < 1e-9


def test_tum_roundtrip_and_bytes(tmp_path):
    ts, t, R, q = _traj(40, seed=1)
    p = str(tmp_path / "traj_pgo.tum")
    pj = str(tmp_path / "traj_pgo_jax.tum")
    logs.write_tum(p, ts, t, q)
    jlogs.write_tum(pj, ts, t, q)
    assert open(p).read() == open(pj).read()
    ts2, t2, q2 = logs.read_tum(p)
    assert np.allclose(ts, ts2)
    assert np.allclose(t, t2, atol=1e-8)
    assert np.allclose(q, q2, atol=1e-8)


@pytest.mark.parametrize("case", ["identity", "moved", "corrupted"])
def test_ape_matches_jax(case):
    ts, t, R, q = _traj(60, seed=3 if case != "identity" else 2)
    t2, R2 = t, R
    if case != "identity":
        Rg = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.1, 0.9],
                                                 jnp.float32)))
        tg = np.array([5.0, -2.0, 1.0], np.float32)
        t2 = t @ Rg.T + tg
        R2 = np.einsum("ij,kjl->kil", Rg, R)
    if case == "corrupted":
        t2 = t2.copy()
        t2[10:20] += 3.0
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    got = ape.ape(f(t2), f(R2), f(t), f(R), align=True)
    want = jape.ape(jnp.asarray(t2), jnp.asarray(R2), jnp.asarray(t),
                    jnp.asarray(R), align=True)
    _close(got, want)
    if case == "identity":
        assert got.rmse_trans < 1e-5 and got.rmse_full < 1e-4
    elif case == "moved":
        assert got.rmse_trans < 1e-4
    else:
        assert got.rmse_trans > 0.5
    # unaligned and with scale, too
    _close(ape.ape(f(t2), f(R2), f(t), f(R), align=False),
           jape.ape(jnp.asarray(t2), jnp.asarray(R2), jnp.asarray(t),
                    jnp.asarray(R), align=False))
    Rs, ts_, s = ape.umeyama_alignment(f(t2) * 2.0, f(t), with_scale=True)
    Rsj, tsj, sj = jape.umeyama_alignment(jnp.asarray(t2) * 2.0,
                                          jnp.asarray(t), with_scale=True)
    np.testing.assert_allclose(Rs.numpy(), np.asarray(Rsj), atol=1e-4)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(tsj), atol=5e-4)
    assert abs(float(s) - float(sj)) <= 1e-5


def test_associate_and_ape_from_tum_match_jax(tmp_path):
    ts_ref = np.arange(100) * 0.05
    for ts_est in (ts_ref[::2] + 0.004, ts_ref[::2] + 0.02):
        for a, b in zip(ape.associate(ts_est, ts_ref, max_diff=0.01),
                        jape.associate(ts_est, ts_ref, max_diff=0.01)):
            assert np.array_equal(a, b)
    ts, t, R, q = _traj(80, seed=4)
    ref, est = str(tmp_path / "gt.tum"), str(tmp_path / "est.tum")
    logs.write_tum(ref, ts, t, q)
    Rg = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.0, 0.5], jnp.float32)))
    logs.write_tum(est, ts + 0.003, t @ Rg.T, np.asarray(
        jlie.rot_to_quat(jnp.asarray(np.einsum("ij,kjl->kil", Rg, R)))))
    got = ape.ape_from_tum(est, ref, device="cpu")
    _close(got, jape.ape_from_tum(est, ref))
    assert got.n_matched == 80 and got.rmse_trans < 1e-4
    # the file-level entry runs on the card unless told otherwise
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ape.ape_from_tum(est, ref)
    assert os.path.getsize(est) > 0
    # align_left and quat_to_rot agree with JAX's
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    Ra, ta = ape.align_left(f(R[0]), f(t[0]), f(R[1]), f(t[1]), f(R), f(t))
    Raj, taj = jape.align_left(R[0], t[0], R[1], t[1], R, t)
    np.testing.assert_allclose(Ra.numpy(), np.asarray(Raj), atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(taj), atol=1e-4)
    np.testing.assert_allclose(lie.quat_to_rot(f(q)).numpy(), R, atol=1e-6)
