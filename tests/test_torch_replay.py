"""The port's replay gate on the CPU: `cli/run.py --mode sim --save-obs`
then `io/replay.py` and `cli/replay.py` on the run's own logs, and against
the JAX package's `io/replay.py` on the same logs and observation streams.
The run: 2 robots x 30 keyframes x 64 features, seed 3, 10 GNC rounds
(tests/test_replay.py's run at 30 keyframes).

Tolerances:
  * own logs: accepted bit for bit (every status equal, mono and stereo
    counts exact, recorded poses within 1e-4 m); a wrong seed rejected;
    `cli/replay` exits 0 and 1 accordingly;
  * `read_recorded_candidates` equal to JAX's, from the sidecar and from
    the reference schema alone, but for each recorded rotation from its
    quaternion, within 1e-6 (XLA's CPU compiler contracts the quaternion
    norm's multiply-adds into FMAs, torch on the CPU rounds each: up to
    6e-7 apart);
  * `replay_verify` against JAX's at a mono threshold of 1e-4: statuses
    and counts equal (at the default 1e-6 the mono count after the
    weighted 8-point refit is not reproducible across packages, ROADMAP
    Queue 3; the own-logs replay holds the port at the default);
  * `replay_ape` within 1e-5 m of JAX's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.cli import replay as replay_cli, run
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig
from kimera_multi_tpu_torch.io import logs, replay, sim_world

torch.set_num_threads(1)

ROBOTS, STEPS, SEED = 2, 30, 3
ARGS = ["--mode", "sim", "--robots", str(ROBOTS), "--steps", str(STEPS),
        "--features", "64", "--seed", str(SEED), "--gnc-rounds", "10",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def sim_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("replay")
    log_dir, obs_dir = str(d / "logs"), str(d / "obs")
    out = run.main(ARGS + ["--log-dir", log_dir, "--save-obs", obs_dir])
    # ground truth as TUM files, from the world the run made
    world = sim_world.make_world(n_robots=ROBOTS, n_steps=STEPS,
                                 features_per_kf=64, seed=SEED)
    gt = {}
    for r in range(ROBOTS):
        gt[r] = str(d / f"gt{r}.tum")
        q = lie.rot_to_quat(torch.from_numpy(world.R_gt[r])).numpy()
        logs.write_tum(gt[r], world.timestamps[r], world.t_gt[r], q)
    return dict(out=out, log_dir=log_dir, obs_dir=obs_dir, gt=gt, dir=d,
                world=world)


def test_save_obs_writes_the_world(sim_run):
    w = sim_run["world"]
    assert sim_run["out"]["stages"]["save_obs_s"] > 0
    for r in range(ROBOTS):
        s = replay.load_observations(replay.obs_path(sim_run["obs_dir"], r))
        np.testing.assert_array_equal(s.descriptors, w.descriptors[r])
        np.testing.assert_array_equal(s.bearings, w.bearings_local[r])
        np.testing.assert_array_equal(s.landmarks, w.landmarks_local[r])
        np.testing.assert_array_equal(s.valid, w.obs_valid[r])
        np.testing.assert_array_equal(s.timestamps, w.timestamps[r])


def test_own_logs_replay_bit_exact(sim_run, monkeypatch):
    rep = replay.replay_verify(sim_run["log_dir"], sim_run["obs_dir"],
                               ROBOTS, FrontendConfig(base_seed=SEED),
                               inlier_tol=0, device="cpu")
    # every attempt the run verified
    assert rep.n_candidates == sim_run["out"]["frontend"]["n_candidates"] > 0
    assert rep.n_status_match == rep.n_candidates
    assert rep.n_mono_exact == rep.n_candidates
    assert rep.n_stereo_exact == rep.n_candidates
    assert rep.max_trans_delta < 1e-4
    assert sum(r["status_replayed"] == "LOOP_DETECTED"
               for r in rep.rows) == len(sim_run["out"]["loops"])
    # a power-of-two pad of 64 verified in pieces of 16: the same rows
    monkeypatch.setattr(replay, "VERIFY_CHUNK", 16)
    small = replay.replay_verify(sim_run["log_dir"], sim_run["obs_dir"],
                                 ROBOTS, FrontendConfig(base_seed=SEED),
                                 device="cpu")
    assert small.rows == rep.rows


def test_cli_gate_exit_codes(sim_run, tmp_path, capsys):
    base = ["--log-dir", sim_run["log_dir"], "--obs-dir",
            sim_run["obs_dir"], "--robots", str(ROBOTS), "--device", "cpu"]
    out_csv = str(tmp_path / "diff.csv")
    gt = [f"robot{r}={p}" for r, p in sim_run["gt"].items()]
    rc = replay_cli.main(base + ["--seed", str(SEED), "--out-csv", out_csv,
                                 "--gt", *gt, "--ape-tol", "0.5"])
    summary = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and summary["accepted"] is True
    assert summary["n_candidates"] == summary["n_mono_exact"] > 0
    cols = logs.read_csv(out_csv)
    assert "status_recorded" in cols and "mono_replayed" in cols
    for r in range(ROBOTS):
        want = sim_run["out"]["ape"][r].rmse_trans
        assert abs(summary["ape"][str(r)]["rmse_trans"] - want) < 1e-4
    # a wrong seed changes RANSAC's samples: the gate fails on exact
    # counts (an APE beyond --ape-tol would fail it too)
    assert replay_cli.main(base + ["--seed", "99", "--gt", *gt,
                                   "--ape-tol", "1e-6"]) == 1
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["accepted"] is False
    assert (summary["n_mono_exact"] < summary["n_candidates"]
            or summary["n_stereo_exact"] < summary["n_candidates"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay_cli.main(base[:-2] + ["--seed", str(SEED)])


def _same_candidates(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for f in ("robot_a", "frame_a", "robot_b", "frame_b",
                  "mono_inliers", "stereo_inliers", "status"):
            assert getattr(x, f) == getattr(y, f), f
        for f, tol in (("R", 1e-6), ("t", 0.0)):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                np.testing.assert_allclose(u, np.asarray(v), rtol=0,
                                           atol=tol, err_msg=f)


def test_read_recorded_candidates_matches_jax(sim_run):
    from kimera_multi_tpu.io import replay as jreplay

    log_dir = sim_run["log_dir"]
    _same_candidates(replay.read_recorded_candidates(log_dir, ROBOTS),
                     jreplay.read_recorded_candidates(log_dir, ROBOTS))
    # the reference schema alone (no lcd_attempts.csv sidecar)
    ref_dir = str(sim_run["dir"] / "reference_schema")
    shutil.copytree(log_dir, ref_dir)
    for r in range(ROBOTS):
        os.remove(os.path.join(ref_dir, f"robot{r}", "distributed",
                               "lcd_attempts.csv"))
    got = replay.read_recorded_candidates(ref_dir, ROBOTS)
    _same_candidates(got, jreplay.read_recorded_candidates(ref_dir, ROBOTS))
    assert sum(c.R is not None for c in got) == len(sim_run["out"]["loops"])


def test_replay_verify_matches_jax(sim_run):
    """At a mono threshold of 1e-4, where the refit's count is
    reproducible: every row's replayed status and counts equal."""
    from kimera_multi_tpu.frontend.dlc import FrontendConfig as JConfig
    from kimera_multi_tpu.io import replay as jreplay

    jcfg = JConfig(base_seed=SEED, mono_threshold=1e-4)
    cfg = convert.config_from_jax(jcfg)
    assert cfg == FrontendConfig(base_seed=SEED, mono_threshold=1e-4)
    args = (sim_run["log_dir"], sim_run["obs_dir"], ROBOTS)
    ref = jreplay.replay_verify(*args, jcfg)
    got = replay.replay_verify(*args, cfg, device="cpu")
    assert got.n_candidates == ref.n_candidates > 0
    for a, b in zip(got.rows, ref.rows):
        td = a.pop("trans_delta"), b.pop("trans_delta")
        assert a == b
        assert abs(td[0] - td[1]) < 1e-4
    assert got.n_status_match == ref.n_status_match
    assert {r["status_replayed"] for r in got.rows} >= {
        "LOOP_DETECTED", "FAILED_GEOM_VERIFICATION"}


def test_replay_ape_matches_jax(sim_run):
    from kimera_multi_tpu.io import replay as jreplay

    got = replay.replay_ape(sim_run["log_dir"], sim_run["gt"], ROBOTS,
                            device="cpu")
    ref = jreplay.replay_ape(sim_run["log_dir"], sim_run["gt"], ROBOTS)
    assert sorted(got) == sorted(ref) == list(range(ROBOTS))
    for r in range(ROBOTS):
        assert got[r]["n_matched"] == ref[r]["n_matched"] == STEPS
        for k in ("rmse_trans", "rmse_full"):
            assert abs(got[r][k] - ref[r][k]) < 1e-5, k
        # the TUM text rounds the poses: the run's own APE within 1e-4
        assert abs(got[r]["rmse_trans"]
                   - sim_run["out"]["ape"][r].rmse_trans) < 1e-4
