"""Repeated-trial harness and median statistics (the JAX package's
cli/trials.py: the reference's run_multi_times.sh, >= 3 trials with
archived log directories, and evo_median.py, median-of-trials APE).

    python -m kimera_multi_tpu_torch.cli.trials --trials 3 --robots 2 \
        --steps 40 --features 64 --log-root TRIALS [--device cpu]

Each trial is a run of the port's CLI (`cli.run.main`) with its own log
directory TRIALS/trial_<i> and seed 1000 + i; on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io import logs


def run_trials(base_args, n_trials: int, log_root: str, vary_seed=True):
    """Run the CLI n_trials times, each trial's logs in its own directory.
    Returns the directories."""
    from . import run as cli_run

    trial_dirs = []
    for i in range(n_trials):
        d = os.path.join(log_root, f"trial_{i:03d}")
        argv = list(base_args) + ["--log-dir", d]
        if vary_seed:
            argv += ["--seed", str(1000 + i)]
        print(f"[trials] trial {i}: {' '.join(argv)}", file=sys.stderr)
        cli_run.main(argv)
        trial_dirs.append(d)
    return trial_dirs


def median_stats(trial_dirs, n_robots: int) -> dict:
    """Per robot, the median (and mean, min, max) over trials of the last
    APE translation RMSE in each trial's ape_robot<r>.csv."""
    out = {}
    for r in range(n_robots):
        vals = []
        for d in trial_dirs:
            p = os.path.join(d, f"ape_robot{r}.csv")
            if not os.path.exists(p):
                continue
            cols = logs.read_csv(p)
            vals.append(float(np.atleast_1d(cols["rmse_trans"])[-1]))
        if vals:
            out[r] = dict(median=float(np.median(vals)),
                          mean=float(np.mean(vals)), min=float(np.min(vals)),
                          max=float(np.max(vals)), n_trials=len(vals))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="repeated-trial harness")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--robots", type=int, default=2)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--features", type=int, default=96)
    p.add_argument("--mode", default="sim")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--log-root", default="kimera_multi_tpu_torch_trials")
    args = p.parse_args(argv)
    base = ["--mode", args.mode, "--robots", str(args.robots),
            "--steps", str(args.steps), "--features", str(args.features),
            "--device", args.device]
    dirs = run_trials(base, args.trials, args.log_root)
    stats = median_stats(dirs, args.robots)
    for r, s in stats.items():
        print(f"robot {r}: median APE {s['median']:.4f} m over "
              f"{s['n_trials']} trials (min {s['min']:.4f}, "
              f"max {s['max']:.4f})")
    return stats


if __name__ == "__main__":
    main()
