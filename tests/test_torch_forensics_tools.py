"""The port's loop-closure forensics (`eval/lc_forensics.py`), the
`--lc-images` flag, the trial harness (`cli/trials.py`) and the live APE
monitor (`cli/monitor.py`) on the CPU.

- `analyze_run` and `inlier_histogram` of both packages on the logs of
  one port `sim` run (tests/test_forensics.py's 2 x 40 x 64, seed 1),
  which also carries `--lc-images` (read by `vio-sim` only: accepted with
  a note and ignored): rows equal in their ids and counts, their float
  columns within 1e-5, the rotation error within 0.05 degrees (the
  arccos of a float32 trace near 3 is ill-conditioned: one ulp of the
  trace moves a 0.1 degree error by 0.015 degrees, ROADMAP Queue 3);
- `extract_lc_images` of both packages on frames made from a seed: the
  same files, PNG bytes equal, manifests equal;
- `vio-sim --lc-images -1` (tests/test_torch_vio_sim.py's 2 x 10 run,
  whose one loop joins two robots at the same rendered frame, distance
  0: the threshold -1 selects every loop): one PNG per loop over it,
  each a PNG that reads back at the pair's size; `vio-sim --artifacts`
  (read by `sim` only): accepted with a note and ignored;
- `run_trials` / `median_stats` as tests/test_misc_io.py's (2 trials at
  2 x 25 x 64), the JAX package's `median_stats` on the same trial
  directories giving the same dict;
- `monitor` of both packages, each on its own copy of three dumps
  against a ground truth moved by a seeded rigid transform and noise:
  the oldest and newest dumps kept, the APE rows within 1e-5 (the full
  metric within 1e-4, as tests/test_torch_ape_logs.py holds it)."""

import json
import os

import numpy as np
import torch

from kimera_multi_tpu.cli import monitor as jmonitor, trials as jtrials
from kimera_multi_tpu.eval import lc_forensics as jlcf
from kimera_multi_tpu_torch.cli import monitor, run, trials
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.eval import lc_forensics
from kimera_multi_tpu_torch.io import convert as io_convert, logs, sim_world

torch.set_num_threads(1)

VIO_ARGS = ["--mode", "vio-sim", "--robots", "2", "--steps", "10",
            "--vio-width", "96", "--vio-height", "72", "--vio-features", "48",
            "--vio-window", "3", "--gnc-rounds", "5", "--seed", "0",
            "--device", "cpu"]


def test_sim_run_forensics_and_ignored_lc_images(tmp_path, capsys):
    log_dir = str(tmp_path / "logs")
    run.main(["--mode", "sim", "--robots", "2", "--steps", "40",
              "--features", "64", "--seed", "1", "--device", "cpu",
              "--lc-images", "30", "--log-dir", log_dir])
    assert "--lc-images is read by --mode vio-sim only; ignored" \
        in capsys.readouterr().err
    assert not os.path.exists(os.path.join(log_dir, "lc_images"))
    world = sim_world.make_world(n_robots=2, n_steps=40, features_per_kf=64,
                                 seed=1)
    gt = {}
    for r in range(2):
        p = str(tmp_path / f"gt_{r}.tum")
        q = lie.rot_to_quat(torch.from_numpy(world.R_gt[r])).numpy()
        logs.write_tum(p, world.timestamps[r], world.t_gt[r], q)
        gt[r] = p
    res = lc_forensics.analyze_run(log_dir, gt, 2,
                                   out_csv=str(tmp_path / "p.csv"))
    ref = jlcf.analyze_run(log_dir, gt, 2, out_csv=str(tmp_path / "j.csv"))
    assert res.n_total == ref.n_total > 5 and res.n_inter == ref.n_inter > 0
    assert res.n_intra == ref.n_intra
    for a, b in zip(res.rows, ref.rows):
        assert a.keys() == b.keys()
        for k in a:
            if k == "rot_err_deg":
                # arccos of a float32 trace near 3: one ulp of the trace
                # moves a ~0.1 degree angle by ~0.015 degrees
                assert abs(a[k] - b[k]) <= 0.05, k
            elif isinstance(b[k], float):
                assert abs(a[k] - b[k]) <= 1e-5, k
            else:
                assert a[k] == b[k], k
    assert np.median(res.rot_err_deg) < 2.0 and not res.suspicious.any()
    assert lc_forensics.inlier_histogram(res) == jlcf.inlier_histogram(ref)
    assert os.path.exists(tmp_path / "p.csv")


def test_extract_lc_images_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (2, 6, 32, 40)).astype(np.float32)
    frames_u8 = (frames * 255).astype(np.uint8)
    rows = [dict(robot1=0, pose1=1, robot2=1, pose2=3, gt_distance=42.5,
                 mono_inliers=17, stereo_inliers=9),
            dict(robot1=0, pose1=2, robot2=1, pose2=4, gt_distance=3.0,
                 mono_inliers=30, stereo_inliers=20),
            dict(robot1=1, pose1=0, robot2=0, pose2=5,
                 gt_distance=np.float64(61.0), mono_inliers=np.int64(11),
                 stereo_inliers=6)]
    for fr in (frames, frames_u8):
        image_of = lambda r, f: fr[r, f]  # noqa: E731
        got = lc_forensics.extract_lc_images(rows, image_of,
                                             str(tmp_path / "p"), 30.0)
        want = jlcf.extract_lc_images(rows, image_of, str(tmp_path / "j"),
                                      30.0)
        assert [os.path.basename(p) for p in got] \
            == [os.path.basename(p) for p in want] and len(got) == 2
        for a, b in zip(got, want):
            assert open(a, "rb").read() == open(b, "rb").read()
        assert json.load(open(tmp_path / "p" / "lc_images.json")) \
            == json.load(open(tmp_path / "j" / "lc_images.json"))


def test_vio_sim_lc_images(tmp_path):
    log_dir = str(tmp_path)
    out = run.main(VIO_ARGS + ["--lc-images", "-1", "--log-dir", log_dir])
    t_gt = out["gt"]["t"]
    over = [lc for lc in out["loops"]
            if np.linalg.norm(t_gt[lc.robot_a, lc.frame_a]
                              - t_gt[lc.robot_b, lc.frame_b]) > -1.0]
    assert len(out["lc_images"]) == len(over) >= 1
    assert out["stages"]["lc_images_s"] >= 0
    manifest = json.load(open(os.path.join(log_dir, "lc_images",
                                           "lc_images.json")))
    assert len(manifest) == len(over)
    for path in out["lc_images"]:
        img = io_convert.load_image(path)
        # the pair side by side (72 x 96 each, a 4-pixel divider) under an
        # 11-row caption strip
        assert img.shape == (72 + 11, 2 * 96 + 4) and img.max() > 0


def test_vio_sim_ignores_artifacts(tmp_path, capsys):
    out = run.main(VIO_ARGS + ["--artifacts", "--log-dir", str(tmp_path)])
    assert "--artifacts is read by --mode sim only; ignored" \
        in capsys.readouterr().err
    assert out["n_keyframes"] == 20 and "artifacts" not in out
    assert not any(os.path.exists(tmp_path / n)
                   for n in ("surface.ply", "mesh.ply", "run.html"))


def test_trial_harness(tmp_path):
    base = ["--mode", "sim", "--robots", "2", "--steps", "25",
            "--features", "64", "--device", "cpu"]
    dirs = trials.run_trials(base, 2, str(tmp_path))
    assert len(dirs) == 2
    stats = trials.median_stats(dirs, 2)
    assert set(stats) == {0, 1}
    for s in stats.values():
        assert s["n_trials"] == 2 and s["median"] < 0.5
        assert s["min"] <= s["median"] <= s["max"]
    assert stats == jtrials.median_stats(dirs, 2)


def test_live_monitor(tmp_path):
    """Watches the dumps, keeps the oldest and newest, appends APE rows
    equal to the JAX package's monitor on the same dumps."""
    rng = np.random.default_rng(0)
    n = 30
    ts = np.arange(n) * 0.5
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0).astype(np.float32)
    R = lie.so3_exp(torch.from_numpy(
        rng.normal(0, 0.3, (n, 3)).astype(np.float32)))
    q = lie.rot_to_quat(R).numpy()
    # ground truth: the dumps under a rigid transform, plus noise that no
    # alignment removes
    R0 = lie.so3_exp(torch.tensor([0.2, -0.4, 0.9]))
    t0 = torch.tensor([1.5, -2.0, 0.5])
    t_gt = (lie.mat3_vec(R0.expand(n, 3, 3), torch.from_numpy(t)) + t0
            + torch.from_numpy(rng.normal(0, 0.05, (n, 3)).astype(
                np.float32)))
    q_gt = lie.rot_to_quat(lie.mat3_mul(R0.expand(n, 3, 3), lie.so3_exp(
        torch.from_numpy(rng.normal(0, 0.02, (n, 3)).astype(np.float32)))
        @ R)).numpy()
    gt_path = str(tmp_path / "gt0.tum")
    logs.write_tum(gt_path, ts, t_gt.numpy(), q_gt)
    rows = {}
    for pkg, mon in (("port", None), ("jax", jmonitor)):
        root = tmp_path / pkg
        rdir = root / "robot0" / "distributed"
        rdir.mkdir(parents=True)
        for k in range(3):
            logs.write_tum(
                str(rdir / f"kimera_distributed_poses_tum_{k}.tum"), ts, t,
                q)
        if mon is None:
            monitor.monitor(str(root), {0: gt_path}, interval=0.01,
                            idle_exit=0.5, max_iters=1, device="cpu")
        else:
            mon.monitor(str(root), {0: gt_path}, interval=0.01,
                        idle_exit=0.5, max_iters=1)
        rows[pkg] = logs.read_csv(str(root / "ape_robot0.csv"))
        assert sorted(p.name for p in rdir.iterdir()) == [
            "kimera_distributed_poses_tum_0.tum",
            "kimera_distributed_poses_tum_2.tum"]
    assert [os.path.basename(p) for p in monitor.newest_tum(
        str(tmp_path / "port" / "robot0"))] == [
            "kimera_distributed_poses_tum_0.tum",
            "kimera_distributed_poses_tum_2.tum"]
    got, want = rows["port"], rows["jax"]
    assert int(np.atleast_1d(got["n_matched"])[-1]) \
        == int(np.atleast_1d(want["n_matched"])[-1]) == n
    rmse = float(np.atleast_1d(got["rmse_trans"])[-1])
    assert 0.02 < rmse < 0.2
    # the full metric within 1e-4, as tests/test_torch_ape_logs.py holds
    # it: the alignment's rotation, through the closed-form 3 x 3
    # eigendecomposition summed in other orders, differs by up to 1e-4
    for col, tol in (("rmse_trans", 1e-5), ("rmse_full", 1e-4)):
        assert abs(float(np.atleast_1d(got[col])[-1])
                   - float(np.atleast_1d(want[col])[-1])) <= tol, col
