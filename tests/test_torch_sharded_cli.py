"""The port's sharded back-end through its CLI on the CPU
(`kimera_multi_tpu_torch.cli.run`): `--mode sim-sharded`, `--backend
sharded` in the vio-sim and euroc modes (and in sim, where the JAX
package's CLI ignores it), `--checkpoint`, `--resume`,
`--profile` and `--chain-refine`, each run once at a small size (2 robots
x 16 keyframes x 48 features, 12 rounds, a dump every 4); two ranks under
torchrun against one; and the slice as
a whole: `sim-sharded` at 2 x 30 x 64 (40 rounds) against the JAX
package's sharded back-end (its cli/run.py `_optimize_backend(...,
sharded=True)`, the rounds by their reference semantics,
tests/_jax_rounds.py) on the port's loops.

Tolerances: the loop closures under weight 0.5 equal; each robot's APE
translation RMSE within 1e-3 m of the JAX back-end's; a resumed run's
final blocks equal the straight run's bit for bit.
"""

import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core.containers import EDGE_ODOMETRY
from kimera_multi_tpu.eval import ape as jape
from kimera_multi_tpu.frontend import dlc as jdlc
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.io import logs, record, render, sim_world
from kimera_multi_tpu_torch.vio.undistort import CameraModel

import _jax_rounds as jax_rounds

torch.set_num_threads(1)

SMALL = ["--robots", "2", "--steps", "16", "--features", "48", "--seed",
         "1", "--gnc-rounds", "12", "--dump-every", "4", "--device", "cpu"]
VIO = ["--mode", "vio-sim", "--robots", "2", "--steps", "8",
       "--vio-width", "96", "--vio-height", "72", "--vio-features", "48",
       "--vio-window", "3", "--gnc-rounds", "6", "--dump-every", "3",
       "--seed", "0", "--device", "cpu"]
CKPT_KEYS = ["Y", "active", "barc2", "mu", "outer_iter", "round_idx",
             "weights"]


def _euroc_roots(d: str) -> list:
    """Two 8-frame sessions 4 frames apart on one rendered arc (96 x 128,
    10 Hz camera, 100 Hz IMU): an ASL tree and a bag."""
    W, H, FX = 128, 96, 110.0
    cam = CameraModel(fx=FX, fy=FX, cx=W / 2, cy=H / 2)
    seq = render.render_sequence(
        render.make_scene(seed=3, n_points=350),
        render.StereoRig(cam=cam, H=H, W=W, baseline=0.2), n_frames=12,
        rate_hz=10.0, imu_rate_hz=100.0, speed=0.6, yaw_rate=0.1,
        device="cpu")
    intr = (FX, FX, W / 2, H / 2)
    return [record.write_asl_session(os.path.join(d, "s0"), seq, intr, 0.2,
                                     0, 8),
            record.write_bag_session(os.path.join(d, "s1.bag"), seq, intr,
                                     0.2, 4, 8)]


def _tums(log_dir, r=0):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(
        log_dir, f"robot{r}", "distributed",
        "kimera_distributed_poses_tum_*.tum")))


def _check_sharded(out, log_dir, n_robots, T, final_idx):
    """Every robot's log tree: a dump every --dump-every rounds and the
    final trajectory, numbered by the global round; finite APE; the
    one-rank group's comm bytes from the analytic model."""
    b = out["backend"]
    assert b["world"] == 1 and b["comm_source"] == "analytic"
    assert b["comm_bytes"] > 0 and b["Y"].shape[:2] == (n_robots, T)
    for r in range(n_robots):
        names = _tums(log_dir, r)
        assert f"kimera_distributed_poses_tum_{final_idx}.tum" in names
        ts, t, _ = logs.read_tum(os.path.join(log_dir, f"robot{r}",
                                              "distributed", names[-1]))
        assert len(ts) == T and np.isfinite(t).all()
        rows = logs.read_csv(os.path.join(log_dir, f"robot{r}",
                                          "distributed", "dpgo_log_0.csv"))
        assert len(np.atleast_1d(rows["iteration"])) == b["round_idx"]
    for res in out["ape"].values():
        assert np.isfinite(res.rmse_trans) and res.rmse_trans < 0.5


CASES = {
    "sim-sharded": ["--mode", "sim-sharded"],
    "sim-backend-sharded": ["--mode", "sim", "--backend", "sharded"],
    "checkpoint": ["--mode", "sim-sharded", "--checkpoint", "CKPT"],
    "resume": ["--mode", "sim-sharded", "--resume", "CKPT"],
    "profile": ["--mode", "sim-sharded", "--profile", "PROF"],
    "chain-refine": ["--mode", "sim-sharded", "--chain-refine"],
    "vio-sim-backend-sharded": ["--backend", "sharded"],
    "euroc-backend-sharded": ["--mode", "euroc", "--backend", "sharded"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_runs_the_sharded_backend(case, tmp_path, capsys):
    """Each mode and flag of the sharded back-end runs on the CPU; `--mode
    sim --backend sharded` takes the single-device back-end with a note,
    as the JAX package's CLI does (it reads `--backend` in vio-sim and
    euroc only)."""
    log_dir = str(tmp_path / "logs")
    ckpt = str(tmp_path / "ckpt.npz")
    prof = str(tmp_path / "prof")
    extra = [{"CKPT": ckpt, "PROF": prof}.get(a, a) for a in CASES[case]]
    if case == "sim-backend-sharded":
        out = run.main(SMALL + extra + ["--log-dir", log_dir])
        assert "--backend is read by --mode vio-sim and euroc only" in \
            capsys.readouterr().err
        assert "robust_pgo_s" in out["stages"]
        assert "rounds_s" not in out["stages"] and "world" not in \
            out["backend"]
        assert _tums(log_dir) == ["kimera_distributed_poses_tum_4.tum"]
        for res in out["ape"].values():
            assert np.isfinite(res.rmse_trans) and res.rmse_trans < 0.5
        return
    if case.startswith("vio"):
        out = run.main(VIO + extra + ["--log-dir", log_dir])
        _check_sharded(out, log_dir, 2, out["n_keyframes"] // 2, 3)
        assert out["n_keyframes"] == 16
        return
    if case.startswith("euroc"):
        roots = _euroc_roots(str(tmp_path))
        out = run.main(extra + ["--euroc-roots", *roots, "--gnc-rounds", "6",
                                "--dump-every", "3", "--device", "cpu",
                                "--log-dir", log_dir])
        assert out["n_keyframes"] == 16
        _check_sharded(out, log_dir, 2, 8, 3)
        return
    if case == "resume":
        # 8 rounds with a checkpoint (saved at every dump), then 4
        # resumed, == 12 straight
        run.main(SMALL + ["--mode", "sim-sharded", "--log-dir", log_dir,
                          "--gnc-rounds", "8", "--checkpoint", ckpt])
        out = run.main(SMALL + ["--gnc-rounds", "4"] + extra
                       + ["--log-dir", log_dir])
        assert out["backend"]["round_idx"] == 12
        straight = run.main(SMALL + ["--mode", "sim-sharded", "--log-dir",
                                     str(tmp_path / "straight")])
        assert torch.equal(out["backend"]["Y"], straight["backend"]["Y"])
        assert torch.equal(out["backend"]["weights"],
                           straight["backend"]["weights"])
        # dumps 0, 1 and the final 3 of the first run, dump 2 and the
        # final 4 of the resumed one: the numbering continues
        assert _tums(log_dir) == [f"kimera_distributed_poses_tum_{k}.tum"
                                  for k in range(5)]
        return
    out = run.main(SMALL + extra + ["--log-dir", log_dir])
    _check_sharded(out, log_dir, 2, 16, 4)
    assert _tums(log_dir) == [f"kimera_distributed_poses_tum_{k}.tum"
                              for k in (0, 1, 2, 4)]
    st = out["stages"]
    assert st["rounds_s"] > 0 and st["polish_s"] > 0 and st["pcm_s"] > 0
    if case == "checkpoint":
        z = np.load(ckpt)
        assert sorted(z.files) == CKPT_KEYS
        assert int(z["round_idx"]) == 12
        assert z["Y"].dtype == np.float32 and z["outer_iter"].dtype == np.int32
        np.testing.assert_array_equal(z["Y"], out["backend"]["Y"].numpy())
    if case == "profile":
        with open(os.path.join(prof, "profile_summary.json")) as f:
            s = json.load(f)
        assert s["files"] == ["trace.json"]
        assert [p["name"] for p in s["planes"]] == ["host", "device"]
        host = s["planes"][0]
        assert set(host) == {"name", "total_event_ms", "busy_ms_by_line",
                             "top_ops"}
        assert host["total_event_ms"] > 0 and host["top_ops"]
        assert set(host["top_ops"][0]) == {"name", "total_ms", "count"}
        assert out["backend"]["profile"] == s
    assert ("chain_refine_s" in st) == (case == "chain-refine")


def test_torchrun_ranks_equal_one_rank(tmp_path):
    """`torchrun --standalone --nproc-per-node 2 -m
    kimera_multi_tpu_torch.cli.run --mode sim-sharded --device cpu`: the
    two processes join one gloo group from the environment (rank 1 of 2
    logs under LOGS/rank1), count the bytes their collectives receive,
    and reach the blocks of a one-rank run (the checkpoint's Y) within
    1e-6."""
    log_dir, ckpt = tmp_path / "ranks", tmp_path / "ckpt.npz"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "kimera_multi_tpu_torch.cli.run",
         *SMALL, "--mode", "sim-sharded", "--checkpoint", str(ckpt),
         "--log-dir", str(log_dir)],
        capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    for rank in (0, 1):
        assert f"robot group: rank {rank} of 2" in p.stderr
    one = run.main(SMALL + ["--mode", "sim-sharded", "--log-dir",
                            str(tmp_path / "one")])
    assert one["backend"]["world"] == 1
    np.testing.assert_allclose(np.load(ckpt)["Y"],
                               one["backend"]["Y"].numpy(), rtol=0,
                               atol=1e-6)
    for d in (log_dir, log_dir / "rank1"):
        rows = logs.read_csv(os.path.join(d, "robot0", "distributed",
                                          "dpgo_log_0.csv"))
        assert (np.atleast_1d(rows["bytes_received"]) > 0).all()
        assert _tums(str(d)) == _tums(str(tmp_path / "one"))


def _jax_sharded_backend(edges, n_robots, ppr, seed, gnc_rounds):
    """The JAX package's sharded back-end (cli/run.py `_optimize_backend(
    ..., sharded=True)`): PCM frames, lifting with the seed's LIFTING key,
    `gnc_rounds` rounds (weights every 2nd round from round 8; their
    reference semantics, tests/_jax_rounds.py), rounding, the gauge and
    the Gauss-Newton polish (5 x 40). Returns (params, weights)."""
    from kimera_multi_tpu.core import lie as jlie, rng as jrng, stiefel as jst
    from kimera_multi_tpu.core.containers import EDGE_SHARED_LC
    from kimera_multi_tpu.solve import pcm as jpcm, pgo as jpgo, rbcd as jrbcd

    p0 = jpgo.init_from_odometry(edges, n_robots, ppr)
    pw, consensus, _ok = jpcm.robot_frame_init(edges, p0, n_robots, ppr)
    shared = edges.valid & (edges.etype == EDGE_SHARED_LC)
    w0 = jnp.where(shared & ~consensus, 0.0, jnp.ones(edges.capacity))
    ylift = jst.random_lifting_matrix(
        jrng.derive(jrng.base_key(seed), jrng.Stream.LIFTING), 5, 3)
    Y0 = jrbcd.lift_params(pw, ylift, n_robots, ppr)
    Y, st = jax_rounds.reference_rounds(
        edges, Y0, jrbcd.RbcdConfig(), ppr, gnc_rounds, every=2, burnin=8,
        init_weights=w0, buckets=jrbcd.bucket_edges(edges, n_robots))
    R, t = jst.round_solution(Y.reshape(-1, *Y.shape[2:]), 3)
    Rg, tg = jlie.se3_inverse(R[0], t[0])
    n = R.shape[0]
    R, t = jlie.se3_compose(jnp.broadcast_to(Rg, (n, 3, 3)),
                            jnp.broadcast_to(tg, (n, 3)), R, t)
    return jpgo.gauss_newton(jpgo.PgoParams(R=R, t=t), edges, st.weights,
                             ppr, gn_iters=5, cg_iters=40), st.weights


def test_sim_sharded_against_the_jax_sharded_backend(tmp_path):
    """The slice as a whole: the port's `sim-sharded` run at 2 x 30 x 64
    (40 rounds) and the JAX package's sharded back-end on the same loops:
    the same loop closures under 0.5, APE within 1e-3 m per robot."""
    log_dir = str(tmp_path / "port")
    out = run.main(["--mode", "sim-sharded", "--robots", "2", "--steps",
                    "30", "--features", "64", "--seed", "1", "--device",
                    "cpu", "--log-dir", log_dir])
    world = sim_world.make_world(n_robots=2, n_steps=30, features_per_kf=64,
                                 seed=1)
    loops = convert.loops_from_numpy(convert.loops_to_numpy(out["loops"]),
                                     record=jdlc.VerifiedLC)
    ej = jdlc.build_pose_graph_from_loops(
        loops, world.R_odo, world.t_odo, jdlc.FrontendConfig(base_seed=1))
    pj, wj = _jax_sharded_backend(ej, 2, 30, seed=1, gnc_rounds=40)
    e = out["backend"]["edges"]
    lc = (e.valid & (e.etype != EDGE_ODOMETRY)).numpy()
    assert lc.sum() == len(out["loops"]) >= 10
    np.testing.assert_array_equal(lc & (out["backend"]["weights"].numpy()
                                        < 0.5),
                                  lc & (np.asarray(wj) < 0.5))
    for r in range(2):
        sl = slice(r * 30, (r + 1) * 30)
        aj = jape.ape(pj.t[sl], pj.R[sl], jnp.asarray(world.t_gt[r]),
                      jnp.asarray(world.R_gt[r]), align=True)
        assert abs(out["ape"][r].rmse_trans - float(aj.rmse_trans)) < 1e-3
