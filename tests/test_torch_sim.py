"""The port's `sim` run end to end on the CPU:
`kimera_multi_tpu_torch.cli.run.main` with tests/test_e2e_sim.py's
arguments (2 robots x 30 keyframes x 64 features, seed 1) and 12 GNC
rounds, held to that test's acceptance (30 TUM rows per robot, the
reference schemas, APE translation RMSE under 0.15 m, accepted loops
with >= 10 mono and >= 5 stereo inliers); its pose graph against the JAX
package's `build_pose_graph_from_loops` on the same loops, and its
back-end against the JAX package's `init_from_odometry` + `robust_pgo`
(12 GNC rounds, 8 Gauss-Newton x 40 CG steps) on the same loops,
carried across as numpy rows (`convert.loops_to_numpy`). One submap run
as tests/test_submap_e2e.py's (2 x 64, seed 7, submaps of 8), and a run
the CLI refuses (the runs of `--artifacts`, `--frontend sequential` and
`--lc-images` are in tests/test_torch_artifacts.py,
test_torch_frontend_sequential.py and test_torch_forensics_tools.py; those
of the sharded back-end in tests/test_torch_sharded_cli.py).

Tolerances: the pose graph equal; loop closures under weight 0.5 equal;
each robot's APE translation RMSE within 1e-3 m of the JAX back-end's
(float32 CG over 328 Gauss-Newton steps drifts apart in the two packages,
ROADMAP Queue 3, so poses are compared through APE, not directly)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core.containers import EDGE_ODOMETRY
from kimera_multi_tpu.eval import ape as jape
from kimera_multi_tpu.frontend import dlc as jdlc
from kimera_multi_tpu.io import logs as jlogs
from kimera_multi_tpu.solve import pgo as jpgo, robust as jrobust
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.cli import run
from kimera_multi_tpu_torch.io import logs, sim_world

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
          "kappa", "tau", "etype")
ARGS = ["--mode", "sim", "--robots", "2", "--steps", "30", "--features",
        "64", "--seed", "1", "--gnc-rounds", "12", "--device", "cpu"]


def test_sim_run_end_to_end(tmp_path):
    """One CLI run (each check below reads it; in one test, so that a
    parallel run does not repeat it on several workers)."""
    log_dir = str(tmp_path)
    out = run.main(ARGS + ["--log-dir", log_dir])
    _check_e2e_acceptance(out, log_dir)
    jax_backend = _jax_backend(out)
    _check_pose_graph(out, jax_backend)
    _check_backend(out, jax_backend)


def _check_e2e_acceptance(out, log_dir):
    assert out["n_keyframes"] == out["n_opt_poses"] == 60
    assert sorted(out["ape"]) == [0, 1]
    for r in range(2):
        base = os.path.join(log_dir, f"robot{r}")
        tums = sorted(glob.glob(os.path.join(
            base, "distributed", "kimera_distributed_poses_tum_*.tum")))
        # 12 rounds, a dump every 10: the final dump is number 2
        assert [os.path.basename(p) for p in tums] == [
            "kimera_distributed_poses_tum_2.tum"]
        ts, t, q = logs.read_tum(tums[0])
        assert len(ts) == 30 and np.isfinite(t).all()
        for name, header in (
                (("distributed", "loop_closures.csv"),
                 "LOOP_CLOSURES_HEADER"),
                (("distributed", "kimera_distributed_keyframes.csv"),
                 "KEYFRAMES_HEADER"),
                (("distributed", "lcd_attempts.csv"), "LCD_ATTEMPTS_HEADER"),
                (("distributed", "dpgo_log_0.csv"), "DPGO_LOG_HEADER"),
                (("single", "output_lcd_status.csv"), "LCD_STATUS_HEADER")):
            cols = logs.read_csv(os.path.join(base, *name))
            assert list(cols) == getattr(jlogs, header).split(","), name
        ape = logs.read_csv(os.path.join(log_dir, f"ape_robot{r}.csv"))
        assert ape["rmse_trans"][0] < 0.15
        assert abs(ape["rmse_trans"][0] - out["ape"][r].rmse_trans) < 1e-12
    lc = logs.read_csv(os.path.join(log_dir, "robot0", "distributed",
                                    "loop_closures.csv"))
    assert len(np.atleast_1d(lc["mono_inliers"])) > 0
    assert (np.atleast_1d(lc["mono_inliers"]) >= 10).all()
    assert (np.atleast_1d(lc["stereo_inliers"]) >= 5).all()
    info = out["backend"]
    assert info["frame_ok"].tolist() == [True, True]
    assert out["frontend"]["n_candidates"] > 0


def _jax_backend(out):
    """The JAX package's back-end on the port's loops."""
    world = sim_world.make_world(n_robots=2, n_steps=30, features_per_kf=64,
                                 seed=1)
    loops = convert.loops_from_numpy(convert.loops_to_numpy(out["loops"]),
                                     record=jdlc.VerifiedLC)
    edges = jdlc.build_pose_graph_from_loops(
        loops, world.R_odo, world.t_odo, jdlc.FrontendConfig(base_seed=1))
    p0 = jpgo.init_from_odometry(edges, 2, 30)
    params, state = jrobust.robust_pgo(p0, edges, 30, gnc_outer_iters=12)
    return world, edges, params, state


def _check_pose_graph(out, jax_backend):
    _, ej, _, _ = jax_backend
    e = out["backend"]["edges"]
    n_lc = int((np.asarray(ej.etype) > EDGE_ODOMETRY).sum())
    assert n_lc == len(out["loops"]) >= 10
    for f in FIELDS:
        assert np.array_equal(getattr(e, f).numpy(),
                              np.asarray(getattr(ej, f))), f


def _check_backend(out, jax_backend):
    world, ej, pj, sj = jax_backend
    e = out["backend"]["edges"]
    lc = (e.valid & (e.etype != EDGE_ODOMETRY)).numpy()
    under = lc & (out["backend"]["weights"].numpy() < 0.5)
    under_j = lc & (np.asarray(sj.weights) < 0.5)
    assert np.array_equal(under, under_j)
    for r in range(2):
        sl = slice(r * 30, (r + 1) * 30)
        aj = jape.ape(pj.t[sl], pj.R[sl], jnp.asarray(world.t_gt[r]),
                      jnp.asarray(world.R_gt[r]), align=True)
        assert abs(out["ape"][r].rmse_trans - aj.rmse_trans) < 1e-3


def test_sim_submaps(tmp_path):
    """tests/test_submap_e2e.py's run: fewer optimized poses, APE in the
    keyframe-level run's class (its absolute bound 0.08 m)."""
    out = run.main(["--mode", "sim", "--robots", "2", "--steps", "64",
                    "--features", "64", "--seed", "7", "--gnc-rounds", "12",
                    "--submap-size", "8", "--device", "cpu",
                    "--log-dir", str(tmp_path)])
    assert out["n_keyframes"] == 128
    assert out["n_opt_poses"] <= 128 / 4
    for r in range(2):
        assert out["ape"][r].rmse_trans < 0.08
        rows = open(os.path.join(
            str(tmp_path), f"robot{r}", "distributed",
            "kimera_distributed_poses_tum_2.tum")).read().splitlines()
        assert len(rows) == 64


@pytest.mark.parametrize("extra,item", [
    (["--mode", "euroc"], "requires --euroc-roots")])
def test_cli_refuses_what_is_not_ported(extra, item, tmp_path):
    with pytest.raises(SystemExit) as e:
        run.main(ARGS + ["--log-dir", str(tmp_path)] + extra)
    assert e.value.code != 0 and item in str(e.value.code)
    assert not os.listdir(tmp_path)


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(args + ["--log-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
