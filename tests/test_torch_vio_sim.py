"""The port's `vio-sim` run end to end on the CPU:
`kimera_multi_tpu_torch.cli.run.main(["--mode", "vio-sim", ...])` at a
tiny size, held to tests/test_vio_sim_e2e.py's gates (inter-robot loops,
translation APE under 0.5 m, the log tree) and to the JAX package's CLI
run with the same arguments, whose numbers are recorded below (the JAX
CLI takes about two minutes on the CPU, mostly compiles, so it is not run
here). `--lc-images` and the ignored `--artifacts` run in
tests/test_torch_forensics_tools.py, `--backend sharded` in
tests/test_torch_sharded_cli.py.

Tolerances: keyframe and loop counts equal to the JAX run's; each
robot's APE translation RMSE within 0.15 m of JAX's (the JAX package's own
tolerance between two back-ends, tests/test_vio_sim_e2e.py). The
full-SE(3) RMSE is not gated at this size: the JAX run gives 2.0 here
(its e2e test's `rmse_full < 1.5` holds at 2 x 16 and the default
widths)."""

import glob
import os

import numpy as np
import pytest
import torch

from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.io import logs

torch.set_num_threads(1)

ARGS = ["--mode", "vio-sim", "--robots", "2", "--steps", "10",
        "--vio-width", "96", "--vio-height", "72", "--vio-features", "48",
        "--vio-window", "3", "--gnc-rounds", "5", "--seed", "0"]
# env JAX_PLATFORMS=cpu python -m kimera_multi_tpu.cli.run --mode vio-sim \
#   --robots 2 --steps 10 --vio-width 96 --vio-height 72 \
#   --vio-features 48 --vio-window 3 --gnc-rounds 5 --seed 0
JAX_RUN = dict(n_keyframes=20, n_loops=1, n_inter_loops=1,
               rmse_trans=(0.0121, 0.0203))


def test_vio_sim_run_end_to_end(tmp_path):
    log_dir = str(tmp_path)
    out = run.main(ARGS + ["--device", "cpu", "--log-dir", log_dir])
    for k in ("n_keyframes", "n_loops", "n_inter_loops"):
        assert out[k] == JAX_RUN[k], k
    for r in range(2):
        res = out["ape"][r]
        assert res.rmse_trans < 0.5 and np.isfinite(res.rmse_full)
        assert abs(res.rmse_trans - JAX_RUN["rmse_trans"][r]) < 0.15
        base = os.path.join(log_dir, f"robot{r}")
        tums = glob.glob(os.path.join(base, "distributed",
                                      "kimera_distributed_poses_tum_*.tum"))
        assert len(tums) == 1
        ts, t, _ = logs.read_tum(tums[0])
        assert len(ts) == 10 and np.isfinite(t).all()
        assert (np.diff(ts) > 0).all()
        status = logs.read_csv(os.path.join(base, "single",
                                            "output_lcd_status.csv"))
        assert list(status) == logs.LCD_STATUS_HEADER.split(",")
        ape = logs.read_csv(os.path.join(log_dir, f"ape_robot{r}.csv"))
        assert abs(ape["rmse_trans"][0] - res.rmse_trans) < 1e-12
    lc = logs.read_csv(os.path.join(log_dir, "robot0", "distributed",
                                    "loop_closures.csv"))
    assert "mono_inliers" in lc
    assert (np.atleast_1d(lc["mono_inliers"]) >= 10).all()
    # every keyframe but each robot's first ran the reject step
    for rej in out["rejection_logs"]:
        assert len(rej) == 10 and rej[0].n_corresp == 0
        assert all(s.n_corresp >= 8 for s in rej[1:])
        assert all(s.mono_inliers >= 8 for s in rej[1:])
    # detection on the card equals the CPU's while BoW weights span
    # less than 2^22 (kernels/bow.py)
    assert 1.0 <= out["bow_weight_span"] < 2.0 ** 22
    assert len(out["stages"]["vio_frame_s"]) == 20


def test_vio_sim_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(ARGS + ["--log-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


# ---- the vio-sim run deeper than 30 frames a robot -----------------------
# VIO alone (no loops, no back-end) over the frame windows of robots 4 and
# 5 of `--robots 6 --steps 40` (stride 20: frames 80 - 119 and 100 - 139)
# at the full width: 640 x 480, 300 features, a window of 25. Odometry
# APE translation RMSE (m) of the final keyframe poses against ground
# truth at keyframe times, recorded on the CPU by
#   env JAX_PLATFORMS=cpu python tests/test_torch_vio_sim.py depth jax 4
#   env JAX_PLATFORMS=cpu python tests/test_torch_vio_sim.py depth port 4
# (and 5): both packages see the frames the port renders. Both fail the
# 0.5 m gate on robot 5, the reference the farther: the arc leaves the
# rendered scene and the stereo gate loses every inlier (0 at its lowest
# in both), so the cut of chip_smoke.py's vio-sim phase to 30 frames a
# robot is a behaviour of the reference's scene, not a fault of the port.
DEPTH_ROBOTS, DEPTH_STEPS, DEPTH_STRIDE = 6, 40, 20
DEPTH_JAX = {4: 0.1576, 5: 5.4746}
DEPTH_PORT_CPU = {4: 0.2329, 5: 3.7592}


def depth_window_ape(package: str, robot: int, frames: int = DEPTH_STEPS):
    """Odometry APE of one robot's window at the full width, by `package`
    ("jax" or "port"), on the CPU."""
    import sys

    from kimera_multi_tpu_torch import convert
    from kimera_multi_tpu_torch.eval import ape as ape_mod
    from kimera_multi_tpu_torch.io import render
    from kimera_multi_tpu_torch.vio import pipeline

    W, H, feats, win = 640, 480, 300, 25
    cfg = run.vio_sim_config(W, H, feats, win)
    f_total = DEPTH_STRIDE * (DEPTH_ROBOTS - 1) + DEPTH_STEPS
    rig = render.StereoRig(cam=cfg.cam, H=H, W=W, baseline=cfg.baseline)
    seq = render.render_sequence(
        render.make_scene(seed=0, n_points=max(350, 4 * feats)), rig,
        n_frames=f_total, rate_hz=10.0, imu_rate_hz=100.0, speed=0.6,
        yaw_rate=0.1, device="cpu")
    if package == "jax":
        from kimera_multi_tpu.vio import pipeline as jpipe

        jcfg = jpipe.PipelineConfig(
            cam=jpipe.CameraModel(*cfg.cam), baseline=cfg.baseline,
            window_size=win, max_features=feats,
            gftt=jpipe.tracking.GfttParams(*cfg.gftt),
            klt=jpipe.tracking.KltParams(*cfg.klt),
            min_intra_keyframe_time=0.0, disparity_threshold=0.0,
            ransac_iterations=200, min_mono_inliers=8,
            min_stereo_inliers=4, vio=jpipe.smoother.VioConfig(gn_iters=12),
            imu=jpipe.imu_mod.ImuParams(gyro_noise=2e-3, accel_noise=2e-2))
        assert convert.vio_config_from_jax(jcfg) == cfg
        vio = jpipe.VioPipeline(jcfg)
    else:
        vio = pipeline.VioPipeline(cfg, device="cpu")
    o = robot * DEPTH_STRIDE
    i = int(np.searchsorted(seq.imu_ts, seq.timestamps[o], side="right"))
    for k in range(o, o + frames):
        ts = seq.timestamps[k]
        while i < len(seq.imu_ts) and seq.imu_ts[i] <= ts:
            vio.add_imu(seq.imu_ts[i], seq.gyro[i], seq.accel[i])
            i += 1
        vio.process_frame(ts, seq.left[k], seq.right[k])
        print(f"frame {k}: {len(vio.keyframes)} keyframes", file=sys.stderr,
              flush=True)
    kf = convert.keyframes_to_numpy(vio.keyframes)
    gi = np.clip(np.searchsorted(seq.timestamps, kf["timestamp"]), 0,
                 f_total - 1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    res = ape_mod.ape(f32(kf["t"]), f32(kf["R"]), f32(seq.t_gt[gi]),
                      f32(seq.R_gt[gi]), align=True)
    return dict(package=package, robot=robot, frames=frames,
                n_keyframes=len(kf["timestamp"]),
                odometry_rmse_trans=res.rmse_trans,
                min_stereo_inliers=int(kf["stereo_inliers"][1:].min()),
                min_mono_inliers=int(kf["mono_inliers"][1:].min()))


if __name__ == "__main__":
    import json
    import sys

    if sys.argv[1:2] == ["depth"]:
        print(json.dumps(depth_window_ape(sys.argv[2], int(sys.argv[3]),
                                          *map(int, sys.argv[4:5]))))
