"""Live APE monitor (the JAX package's cli/monitor.py: the reference's
evo_real_time.py).

    python -m kimera_multi_tpu_torch.cli.monitor --log-dir LOGS \
        --gt 0=GT0.tum 1=GT1.tum [--interval 5] [--idle-exit 30] \
        [--device cpu]

Every `--interval` seconds: each robot's newest
`kimera_distributed_poses_tum_*.tum`, older dumps removed (the oldest and
the newest kept, del_poses_files.sh), associated to the ground truth
(max_diff 0.01 s), aligned, APE translation and full RMSE appended to
ape_robot<r>.csv. Exits once the log directory has not changed for
`--idle-exit` seconds. The APE runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from ..eval import ape as ape_mod


def newest_tum(robot_dir: str) -> list:
    """A robot's trajectory dumps, oldest first (by dump index)."""
    pat = os.path.join(robot_dir, "distributed",
                       "kimera_distributed_poses_tum_*.tum")
    return sorted(glob.glob(pat),
                  key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))


def gc_dumps(files) -> None:
    """Keep the oldest and the newest dump."""
    for p in files[1:-1]:
        try:
            os.remove(p)
        except OSError:
            pass


def monitor(log_dir: str, gt: dict, interval: float = 5.0,
            idle_exit: float = 30.0, max_iters: int | None = None,
            device="cuda") -> None:
    """Watch `log_dir` (robot<r>/distributed/ dumps) against the ground
    truth TUM files `gt` (robot -> path); `max_iters` passes at most."""
    last_change = time.monotonic()
    seen: dict = {}
    it = 0
    while True:
        it += 1
        for r, gt_path in gt.items():
            files = newest_tum(os.path.join(log_dir, f"robot{r}"))
            if not files:
                continue
            latest = files[-1]
            mtime = os.path.getmtime(latest)
            if seen.get(r) == (latest, mtime):
                continue
            seen[r] = (latest, mtime)
            last_change = time.monotonic()
            gc_dumps(files)
            try:
                res = ape_mod.ape_from_tum(latest, gt_path, device=device)
            except (OSError, ValueError) as e:
                print(f"[monitor] robot {r}: {e}", file=sys.stderr)
                continue
            out = os.path.join(log_dir, f"ape_robot{r}.csv")
            new = not os.path.exists(out)
            with open(out, "a") as f:
                if new:
                    f.write("timestamp,rmse_trans,rmse_full,n_matched\n")
                f.write(f"{time.time()},{res.rmse_trans},{res.rmse_full},"
                        f"{res.n_matched}\n")
            print(f"[monitor] robot {r}: APE {res.rmse_trans:.4f} m "
                  f"({res.n_matched} poses)", file=sys.stderr)
        if max_iters is not None and it >= max_iters:
            return
        if time.monotonic() - last_change > idle_exit:
            print("[monitor] idle: exiting", file=sys.stderr)
            return
        time.sleep(interval)


def main(argv=None):
    p = argparse.ArgumentParser(description="live APE monitor")
    p.add_argument("--log-dir", required=True)
    p.add_argument("--gt", nargs="+", required=True,
                   help="robot=path pairs, e.g. 0=gt0.tum")
    p.add_argument("--interval", type=float, default=5.0)
    p.add_argument("--idle-exit", type=float, default=30.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    gt = {}
    for spec in args.gt:
        r, path = spec.split("=", 1)
        gt[int(r)] = path
    monitor(args.log_dir, gt, args.interval, args.idle_exit,
            device=args.device)


if __name__ == "__main__":
    main()
