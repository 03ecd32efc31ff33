"""Replay-acceptance CLI: diff a recorded run against a re-verification
(the JAX package's cli/replay.py).

Point it at a log directory in the reference schema plus recorded
observation streams (`cli/run.py --save-obs`, `io/convert.py`); it re-runs
every recorded loop-closure candidate through the port's batched verifier
and reports status and inlier equality row by row; `--gt` adds the APE
trajectory acceptance.

  python -m kimera_multi_tpu_torch.cli.replay --log-dir LOGS --obs-dir OBS \\
      --robots 6 [--seed 0] [--inlier-tol 0] [--out-csv diff.csv] \\
      [--gt robot0=gt0.tum ...] [--ape-tol M] [--device cpu]

Prints one JSON summary to stdout; exits 1 if any row mismatches beyond
tolerance (or an APE exceeds `--ape-tol`), else 0, so it doubles as an
acceptance gate. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="kimera_multi_tpu_torch replay")
    p.add_argument("--log-dir", required=True)
    p.add_argument("--obs-dir", required=True)
    p.add_argument("--robots", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--inlier-tol", type=int, default=0,
                   help="allowed |recorded-replayed| inlier delta "
                        "(0 = bit-equality, own-logs acceptance)")
    p.add_argument("--out-csv", default=None,
                   help="write the row-by-row diff here")
    p.add_argument("--gt", nargs="*", default=[],
                   help="robot<k>=<gt.tum> pairs for APE acceptance")
    p.add_argument("--ape-tol", type=float, default=None,
                   help="fail if any robot's translation APE exceeds this")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..core import backend
    from ..frontend.dlc import FrontendConfig
    from ..io import replay as replay_mod

    dev = backend.resolve_device(args.device)
    cfg = FrontendConfig(base_seed=args.seed)
    rep = replay_mod.replay_verify(
        args.log_dir, args.obs_dir, args.robots, cfg,
        inlier_tol=args.inlier_tol, out_csv=args.out_csv, device=dev)

    summary = dict(
        n_candidates=rep.n_candidates,
        n_status_match=rep.n_status_match,
        n_mono_exact=rep.n_mono_exact,
        n_stereo_exact=rep.n_stereo_exact,
        max_mono_delta=rep.max_mono_delta,
        max_stereo_delta=rep.max_stereo_delta,
        max_trans_delta=rep.max_trans_delta,
    )
    ok = (rep.n_status_match == rep.n_candidates
          and rep.n_mono_within_tol == rep.n_candidates
          and rep.n_stereo_within_tol == rep.n_candidates)

    if args.gt:
        gt = {}
        for item in args.gt:
            name, path = item.split("=", 1)
            gt[int(name.replace("robot", ""))] = path
        ape = replay_mod.replay_ape(args.log_dir, gt, args.robots,
                                    device=dev)
        summary["ape"] = ape
        if args.ape_tol is not None:
            ok = ok and all(v["rmse_trans"] <= args.ape_tol
                            for v in ape.values())

    summary["accepted"] = ok
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
