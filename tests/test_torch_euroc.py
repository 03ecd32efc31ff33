"""The port's recorded-data path on the CPU: `io/convert.py` (the VIO
pipeline over a recorded session, the converter CLI) and `cli/run.py
--mode euroc`, against the JAX package on the same files. Sessions are
written from sequences the port renders by `io/record.py` (EuRoC's ASL
layout or a rosbag1 file).

Tolerances:
  * `euroc_to_observations` on a 128 x 96 session of 8 frames at
    tests/test_convert.py's rates (10 Hz camera, 100 Hz IMU), both
    packages given a window of 3 (it bounds the JAX smoother's compiles):
    keyframe count and the first keyframe's validity equal, its
    descriptors' bits equal but for 0.1 % (describe's box filter sums in
    float32 in another order than XLA's convolution: a BRIEF pair within
    an ulp of a tie flips; tests/test_torch_vio_pipeline.py allows 1 %);
    both packages also given the vio-sim run's 12 Gauss-Newton iterations
    (the converter's 5 stop short along J^T J's near-null directions and
    leave the packages up to 0.017 rad apart, ROADMAP Queue 3): every
    keyframe's final position within 2e-3 m
    (tests/test_torch_vio_pipeline.py's tolerance; 6.6e-4 here) and
    rotation within 2.5e-3 of JAX's (2.2e-3 here, keyframe 0, about the
    camera's x axis: from bit-equal states one Gauss-Newton step leaves
    the packages 4.4e-2 apart along that direction, which the damped
    iterations then leave at 2.22e-3, 2.24e-3, 2.24e-3 after 12, 20, 40;
    the float32 triangulation gives the same; tests/test_torch_vio_pipeline
    .py's 2e-3 holds on its own session);
  * the `euroc` CLI on two 20-frame sessions, one ASL tree and one bag
    without ground truth, against the JAX CLI's run on the same files
    (`JAX_RUN`, recorded below; the JAX CLI takes minutes of compiles):
    keyframes equal; every loop of the JAX run found and at most one more
    (the keyframe products differ in a few descriptor bits and in the
    smoother's last digits, so a BoW score near the detection gate can
    land on either side: the port finds 9, JAX 8); APE translation within
    0.15 m (the JAX package's own tolerance between two back-ends);
  * a session written as an ASL tree and as a bag: equal keyframe
    products, through the converter CLI for the bag."""

import os

import numpy as np
import pytest
import torch

from kimera_multi_tpu_torch import convert as state
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.io import (convert, dataset, logs, record, render,
                                       replay)
from kimera_multi_tpu_torch.vio import pipeline
from kimera_multi_tpu_torch.vio.undistort import CameraModel

torch.set_num_threads(1)

H, W, FX = 96, 128, 110.0
INTR = (FX, FX, W / 2, H / 2)
BASE = 0.2
FRAMES, WIN = 8, 3
# keyframe poses, port against JAX, after 12 Gauss-Newton iterations a
# window (module docstring)
GN_ITERS = 12
POS_TOL, ROT_TOL = 2e-3, 2.5e-3
# the CLI's sessions: tests/test_convert.py's end-to-end run (two
# 20-frame windows 8 frames apart on one arc, 10 Hz camera, 100 Hz IMU)
CLI_F, CLI_STRIDE = 20, 8
CLI_ARGS = ["--mode", "euroc", "--gnc-rounds", "20", "--seed", "0"]
# env JAX_PLATFORMS=cpu python tests/test_torch_euroc.py
JAX_RUN = dict(n_keyframes=40, n_loops=8, n_inter_loops=8,
               rmse_trans=(0.0475,),
               loops=[(0, 10, 1, 2), (0, 11, 1, 2), (0, 14, 1, 6),
                      (0, 15, 1, 7), (0, 16, 1, 8), (0, 17, 1, 9),
                      (0, 18, 1, 10), (0, 19, 1, 11)])


def _seq(n_frames, seed, rate=10.0, imu_rate=100.0):
    cam = CameraModel(fx=FX, fy=FX, cx=W / 2, cy=H / 2)
    rig = render.StereoRig(cam=cam, H=H, W=W, baseline=BASE)
    return render.render_sequence(
        render.make_scene(seed=seed, n_points=350), rig, n_frames=n_frames,
        rate_hz=rate, imu_rate_hz=imu_rate, speed=0.6, yaw_rate=0.1,
        device="cpu")


def cli_sessions(d: str):
    """Robot 0: an ASL tree of PNG frames; robot 1: a bag 8 frames later
    on the same arc, without ground truth."""
    seq = _seq(CLI_F + CLI_STRIDE, seed=3)
    return [record.write_asl_session(os.path.join(d, "sess0"), seq, INTR,
                                     BASE, 0, CLI_F, image_format="png"),
            record.write_bag_session(os.path.join(d, "sess1.bag"), seq, INTR,
                                     BASE, CLI_STRIDE, CLI_F, with_gt=False)]


def _jax_config(jpipe, s):
    """The JAX converter's configuration (its io/convert.py) at window
    WIN and GN_ITERS Gauss-Newton iterations."""
    fu, fv, cu, cv = s.intrinsics
    return jpipe.PipelineConfig()._replace(
        cam=jpipe.CameraModel(fx=fu, fy=fv, cx=cu, cy=cv),
        baseline=s.baseline if s.cam1_files else 0.0,
        window_size=WIN, max_features=96,
        gftt=jpipe.tracking.GfttParams(max_features=96, min_distance=6,
                                       quality_level=0.001),
        klt=jpipe.tracking.KltParams(win_size=12, max_level=3, max_iter=20),
        min_intra_keyframe_time=0.0, disparity_threshold=0.0,
        ransac_iterations=200, min_mono_inliers=8, min_stereo_inliers=4,
        vio=jpipe.smoother.VioConfig(gn_iters=GN_ITERS))


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("euroc")
    seq = _seq(FRAMES + 2, seed=4)
    return dict(
        asl=record.write_asl_session(str(d / "asl"), seq, INTR, BASE, 1,
                                     FRAMES),
        bag=record.write_bag_session(str(d / "s.bag"), seq, INTR, BASE, 1,
                                     FRAMES),
        mono=record.write_asl_session(str(d / "mono"), seq, INTR, BASE, 1,
                                      FRAMES, stereo=False, with_gt=False),
        dir=d)


def test_euroc_to_observations_matches_jax(session):
    from kimera_multi_tpu.io import convert as jconvert
    from kimera_multi_tpu.vio import pipeline as jpipe

    root = session["asl"]
    s = dataset.load_euroc(root)
    jcfg = _jax_config(jpipe, s)
    conv = convert.euroc_config(s, H, W)
    cfg = conv._replace(window_size=WIN,
                        vio=conv.vio._replace(gn_iters=GN_ITERS))
    assert state.vio_config_from_jax(jcfg) == cfg
    assert conv.window_size == 8 and conv.vio.gn_iters == 5
    ref, _, (jR, jt) = jconvert.euroc_to_observations(root, cfg=jcfg,
                                                      log=lambda m: None)
    st = {}
    got, sess, (R, t) = convert.euroc_to_observations(
        root, cfg=cfg, device="cpu", stats=st)
    assert got.descriptors.shape == ref.descriptors.shape == (FRAMES, 96, 32)
    np.testing.assert_array_equal(got.timestamps, ref.timestamps)
    # the same detections; BRIEF bits on the 5 x 5 box-smoothed image,
    # whose float32 sums XLA's convolution and torch's order differently,
    # so a pair within an ulp of a tie can flip (1 bit in 24,576 here)
    np.testing.assert_array_equal(got.valid[0], ref.valid[0])
    same = (np.unpackbits(got.descriptors[0])
            == np.unpackbits(ref.descriptors[0]))
    assert same.mean() >= 0.999, same.mean()
    assert got.valid[0].sum() >= 50
    np.testing.assert_allclose(t, np.asarray(jt), rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(R, np.asarray(jR), rtol=0, atol=ROT_TOL)
    # the streams' other fields come from the same keyframes
    assert got.valid.sum() > 0.6 * got.valid.size
    assert (np.abs(got.landmarks).sum(-1)[got.valid] > 0).all()
    assert len(st["frame_s"]) == FRAMES and st["io_s"] > 0
    assert len(st["rejection_log"]) == FRAMES
    assert np.linalg.norm(t[-1] - t[0]) > 0.3  # it moved: 0.06 m a frame


def test_asl_and_bag_give_equal_keyframe_products(session):
    """The same frames as an ASL tree and as a bag: the bag through the
    converter CLI (`--bag`), the tree through euroc_to_observations; and
    a mono session (no cam1) keeps validity alone."""
    d = session["dir"]
    out = str(d / "converted")
    assert convert.main(["--bag", session["bag"], "--out", out,
                         "--device", "cpu"]) == 0
    got = replay.load_observations(replay.obs_path(out, 0))
    ref = convert.euroc_to_observations(session["asl"], device="cpu")[0]
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    gts, gt_t, gt_q = logs.read_tum(os.path.join(out, "gt_robot0.tum"))
    s = dataset.load_euroc(session["asl"])
    np.testing.assert_allclose(gt_t, s.gt_t, atol=1e-6)
    np.testing.assert_allclose(gt_q, s.gt_q, atol=1e-6)
    mono, ms, _ = convert.euroc_to_observations(session["mono"],
                                                device="cpu")
    assert ms.baseline == 0.0 and not np.abs(mono.landmarks).any()
    assert mono.valid.sum() > 0.5 * mono.valid.size


def test_converter_runs_on_the_card_by_default(session, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.main(["--euroc", session["asl"], "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(CLI_ARGS + ["--euroc-roots", session["asl"],
                             "--log-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit):
        convert.main(["--out", str(tmp_path), "--device", "cpu"])


def _drop_a_keyframe(orig):
    """process_frame that loses the pipeline's second keyframe."""
    def wrapped(self, *a, **k):
        out = orig(self, *a, **k)
        if len(self.keyframes) == 3 and not getattr(self, "_dropped", 0):
            self._dropped = 1
            self.keyframes.pop(1)
        return out
    return wrapped


def test_a_misaligned_keyframe_list_raises(session, monkeypatch, tmp_path):
    monkeypatch.setattr(pipeline.VioPipeline, "process_frame",
                        _drop_a_keyframe(pipeline.VioPipeline.process_frame))
    with pytest.raises(RuntimeError, match="holds 4 keyframes but made 5"):
        convert.euroc_to_observations(session["asl"], device="cpu",
                                      max_frames=5)
    with pytest.raises(RuntimeError, match="holds 3 keyframes but made 4"):
        run.main(["--mode", "vio-sim", "--robots", "2", "--steps", "4",
                  "--vio-width", "96", "--vio-height", "72",
                  "--vio-features", "48", "--vio-window", "3", "--device",
                  "cpu", "--log-dir", str(tmp_path)])


def test_euroc_run_end_to_end(tmp_path):
    roots = cli_sessions(str(tmp_path))
    log_dir = str(tmp_path / "logs")
    out = run.main(CLI_ARGS + ["--euroc-roots", *roots, "--device", "cpu",
                               "--log-dir", log_dir])
    assert out["n_keyframes"] == JAX_RUN["n_keyframes"]
    # the keyframe products differ in a few descriptor bits (describe's
    # box filter) and in the smoother's last digits, so BoW scores differ
    # in their third digit: every loop of the JAX run is found, and one
    # more (0, 9, 1, 1) at a BoW score of 0.81
    loops = [(lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b)
             for lc in out["loops"]]
    assert set(JAX_RUN["loops"]) <= set(loops)
    assert out["n_loops"] - JAX_RUN["n_loops"] <= 1
    assert out["n_inter_loops"] - JAX_RUN["n_inter_loops"] <= 1
    # robot 1's session has no ground truth: its APE is suppressed, its
    # logs are written
    assert list(out["ape"]) == [0] and out["gt"]["mask"] == [True, False]
    res = out["ape"][0]
    assert res.rmse_trans < 0.5
    assert abs(res.rmse_trans - JAX_RUN["rmse_trans"][0]) < 0.15
    assert os.path.isfile(os.path.join(log_dir, "ape_robot0.csv"))
    assert not os.path.exists(os.path.join(log_dir, "ape_robot1.csv"))
    T = out["n_keyframes"] // 2
    for r in range(2):
        ts, t, _ = logs.read_tum(os.path.join(
            log_dir, f"robot{r}", "distributed",
            "kimera_distributed_poses_tum_3.tum"))
        assert len(ts) == T and np.isfinite(t).all()
        np.testing.assert_allclose(ts, out["observations"][r]
                                   .timestamps[:T], rtol=0, atol=1e-9)
        for name, header in (("single/output_lcd_status.csv",
                              logs.LCD_STATUS_HEADER),
                             ("distributed/lcd_attempts.csv",
                              logs.LCD_ATTEMPTS_HEADER),
                             ("distributed/loop_closures.csv",
                              logs.LOOP_CLOSURES_HEADER)):
            with open(os.path.join(log_dir, f"robot{r}", name)) as f:
                assert f.readline().strip() == header
    # the bag became an ASL tree under the log directory
    assert os.path.isdir(os.path.join(log_dir, "bags", "bag_robot1", "mav0"))
    st = out["stages"]
    assert len(st["vio_frame_s"]) == 2 * CLI_F
    assert st["io_s"] > 0 and st["vio_s"] > st["io_s"]
    assert 1.0 <= out["bow_weight_span"] < 2.0 ** 22


if __name__ == "__main__":
    # records JAX_RUN: the JAX package's CLI on cli_sessions()
    import json
    import tempfile

    from kimera_multi_tpu.cli import run as jrun

    with tempfile.TemporaryDirectory() as d:
        roots = cli_sessions(d)
        o = jrun.main(CLI_ARGS + ["--euroc-roots", *roots, "--log-dir",
                                  os.path.join(d, "logs")])
        print(json.dumps(dict(
            n_keyframes=o["n_keyframes"], n_loops=o["n_loops"],
            n_inter_loops=o["n_inter_loops"],
            loops=[(int(a), int(b), int(c), int(e)) for a, b, c, e in
                   zip(*(np.atleast_1d(logs.read_csv(os.path.join(
                       d, "logs", "robot0", "distributed",
                       "loop_closures.csv"))[k])
                       for k in ("robot1", "pose1", "robot2", "pose2")))],
            rmse_trans=[o["ape"][r].rmse_trans for r in sorted(o["ape"])])))
