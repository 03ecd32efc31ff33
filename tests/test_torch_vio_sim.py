"""The port's `vio-sim` run end to end on the CPU:
`kimera_multi_tpu_torch.cli.run.main(["--mode", "vio-sim", ...])` at a
tiny size, held to tests/test_vio_sim_e2e.py's gates (inter-robot loops,
translation APE under 0.5 m, the log tree) and to the JAX package's CLI
run with the same arguments, whose numbers are recorded below (the JAX
CLI takes about two minutes on the CPU, mostly compiles, so it is not run
here). Also the modes and flags of the vio-sim path that are not ported.

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


@pytest.mark.parametrize("extra,item", [
    (["--backend", "sharded"], "M11"), (["--lc-images", "30"], "M14"),
    (["--euroc-roots", "x"], "M12")])
def test_vio_sim_refuses_what_is_not_ported(extra, item, tmp_path):
    with pytest.raises(SystemExit) as e:
        run.main(ARGS + ["--device", "cpu", "--log-dir", str(tmp_path)]
                 + extra)
    assert e.value.code != 0 and item in str(e.value.code)
    assert not os.listdir(tmp_path)


def test_vio_sim_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(ARGS + ["--log-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
