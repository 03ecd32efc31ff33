"""The control of the comparison: the plain reference put in the
program's place one precision step down (float32 with TF32 products, the
step below the float32-with-TF32-off that the configuration states),
judged by the same comparison against the float64 reference on the same
sampled candidates a run compares. It must come out not correct.

    python -m portbench.control --workload <cell> --seeds 11 12 13

prints one JSON line per seed with the numbers compared, each beside its
limit, and `correct`. Runs on the card when there is one (the cell's own
sizes), else on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import backlog as backlog_mod
from . import compare, reference, spec, threefry
from .run import world_of


def readings(c: dict, seed: int, device) -> dict:
    """The control's and the reference's answers for the sampled
    candidates of `seed`, and the comparison's numbers."""
    cfg = c["config"]
    world = world_of(cfg, seed)
    bl = backlog_mod.make_backlog(world, c["traffic"], seed)
    key = threefry.base_key(seed)
    pick = compare.sample(bl.n, c["limits"]["sample"], seed)
    args = (bl.qr[pick], bl.qf[pick], bl.tr[pick], bl.tm[pick])
    t = time.perf_counter()
    ref = reference.verify(world, cfg, key, *args, device=device)
    ctl = reference.verify(world, cfg, key, *args, precision="tf32",
                           device=device)
    secs = time.perf_counter() - t
    prog = {k: (v if k == "match" else v[None]) for k, v in ctl.items()}
    nums = compare.numbers(prog, ref, cfg)
    correct, rows = compare.judge(nums, c["limits"]["limits"])
    return {"seed": seed, "correct": correct,
            "checks": {k: {"value": v, "limit": lim} for k, v, lim in rows},
            "reported": {k: nums[k] for k in compare.REPORTED},
            "seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    c = spec.cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds:
        print(json.dumps({"workload": args.workload, "device": device,
                          **readings(c, s, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
