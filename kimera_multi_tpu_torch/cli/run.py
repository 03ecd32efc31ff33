"""End-to-end run entry point of the port (the JAX package's cli/run.py,
its `sim` mode with the single-device back-end).

    python -m kimera_multi_tpu_torch.cli.run --mode sim --robots 2 \
        --steps 30 --features 64 --seed 1 --log-dir LOGS [--device cpu]

sim: synthetic sensor world -> vocabulary -> batched front-end (BoW
detection, RANSAC verification) -> pose graph (optionally coarsened to
submaps) -> PCM + GNC robust PGO -> reference-schema logs + APE per robot.
Runs on the card unless `--device cpu` is given; asking for the card
where there is none raises.

Outputs under --log-dir follow the reference contract:
  robot<r>/distributed/kimera_distributed_poses_tum_<k>.tum
  robot<r>/distributed/loop_closures.csv
  robot<r>/distributed/kimera_distributed_keyframes.csv
  robot<r>/distributed/lcd_attempts.csv
  robot<r>/distributed/dpgo_log_0.csv
  robot<r>/single/output_lcd_status.csv
  ape_robot<r>.csv

The JAX package's other modes and flags are not ported yet; each exits
non-zero with a message naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# mode / flag -> what is missing (ROADMAP Queue 1)
_NOT_PORTED = {
    "sim-sharded": "the sharded back-end (ROADMAP Queue 1 item 6, M11)",
    "vio-sim": "VIO (ROADMAP Queue 1 item 7, M12)",
    "euroc": "VIO on recorded data (ROADMAP Queue 1 item 7, M12)",
    "--backend sharded": "the sharded back-end (ROADMAP Queue 1 item 6, "
                         "M11)",
    "--frontend sequential": "the sequential front-end DistributedFrontend "
                             "(ROADMAP Queue 1 item 4, M10 remainder)",
    "--artifacts": "meshing (ROADMAP Queue 1 item 8, M13)",
    "--checkpoint": "round-state checkpoints (ROADMAP Queue 1 item 6, M11)",
    "--resume": "round-state checkpoints (ROADMAP Queue 1 item 6, M11)",
    "--profile": "the sharded rounds' profile (ROADMAP Queue 1 item 6, M11)",
    "--chain-refine": "the chain solver (ROADMAP Queue 1 item 6, M11)",
    "--save-obs": "observation streams for replay (ROADMAP Queue 1 item 9, "
                  "M14)",
}


def main(argv=None):
    p = argparse.ArgumentParser(description="kimera_multi_tpu_torch runner")
    p.add_argument("--mode", choices=["sim", "sim-sharded", "vio-sim",
                                      "euroc"], default="sim")
    p.add_argument("--backend", choices=["single", "sharded"],
                   default="single")
    p.add_argument("--robots", type=int, default=2)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--features", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-dir", default="kimera_multi_tpu_torch_logs")
    p.add_argument("--gnc-rounds", type=int, default=40)
    p.add_argument("--dump-every", type=int, default=10,
                   help="names the final trajectory dump "
                        "kimera_distributed_poses_tum_<gnc_rounds // "
                        "dump_every + 1>.tum")
    p.add_argument("--submap-size", type=int, default=0,
                   help="coarsen the back-end graph to submaps of up to "
                        "this many keyframes (0 = keyframe level)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--frontend", choices=["batched", "sequential"],
                   default="batched")
    p.add_argument("--artifacts", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--profile", default=None, metavar="DIR")
    p.add_argument("--chain-refine", action="store_true")
    p.add_argument("--save-obs", default=None)
    args = p.parse_args(argv)

    asked = [args.mode] if args.mode != "sim" else []
    asked += [f"--backend {args.backend}"] * (args.backend != "single")
    asked += [f"--frontend {args.frontend}"] * (args.frontend != "batched")
    asked += [flag for flag, on in (
        ("--artifacts", args.artifacts), ("--checkpoint", args.checkpoint),
        ("--resume", args.resume), ("--profile", args.profile),
        ("--chain-refine", args.chain_refine),
        ("--save-obs", args.save_obs)) if on]
    if asked:
        raise SystemExit(f"kimera_multi_tpu_torch.cli.run: {asked[0]} is "
                         f"not ported yet: {_NOT_PORTED[asked[0]]}")
    return run_sim(args)


def run_sim(args):
    """The `sim` mode. Returns dict(ape, n_opt_poses, n_keyframes) as the
    JAX package's run_sim does, and besides: `stages` (seconds on a
    synchronised clock: front-end, build_pose_graph, submaps, pcm,
    robust_pgo, logs), `frontend` (the front-end's stats), `loops` (the
    accepted `VerifiedLC` records) and `backend`
    (the pose graph `edges`, PCM's `consensus` and `frame_ok`, the final
    `weights` and `params`, before any submap expansion)."""
    import torch

    from ..core import backend
    from ..frontend import batched, vocab as vocab_mod
    from ..frontend.dlc import FrontendConfig
    from ..io import sim_world
    from ..solve import pgo

    dev = backend.resolve_device(args.device)
    t_start = time.time()
    stages = {}
    print(f"[run] building world: {args.robots} robots x {args.steps} "
          f"steps", file=sys.stderr)
    world = sim_world.make_world(
        n_robots=args.robots, n_steps=args.steps,
        features_per_kf=args.features, seed=args.seed)
    # vocabulary trained on the world's descriptor corpus (role of
    # mit_voc.yml; the reference trains offline too)
    corpus = world.descriptors[world.obs_valid].reshape(-1, 32)
    sub = corpus[:: max(1, len(corpus) // 4000)]
    voc = vocab_mod.build_vocabulary(sub, k=8, depth=3, seed=args.seed,
                                     device=dev)
    cfg = FrontendConfig(base_seed=args.seed)
    fe = batched.BatchedFrontend(args.robots, args.steps, voc, cfg,
                                 device=dev)
    print("[run] front-end (batched detect + verify)...", file=sys.stderr)
    t = backend.synced_clock(dev)
    fe_stats = fe.process_all(world.descriptors, world.bearings_local,
                              world.landmarks_local, world.obs_valid)
    stages["frontend_s"] = backend.synced_clock(dev) - t
    print(f"[run] committed loop closures: {len(fe.loops)} (attempts "
          f"{len(fe.lcd_attempts)})", file=sys.stderr)

    t = backend.synced_clock(dev)
    edges = fe.build_pose_graph(world.R_odo, world.t_odo)
    stages["build_pose_graph_s"] = backend.synced_clock(dev) - t

    # ---- submap coarsening (getSubmapPoseGraph) ----------------------
    expand_fn = None
    ppr = args.steps  # back-end poses per robot
    if args.submap_size > 0:
        from ..frontend import submap as submap_mod

        t = backend.synced_clock(dev)
        R_kf, t_kf = _odometry_poses(world)
        assigns = [
            submap_mod.assign_submaps(
                torch.from_numpy(R_kf[r]).to(dev),
                torch.from_numpy(t_kf[r]).to(dev),
                torch.ones(args.steps, dtype=torch.bool, device=dev),
                max_submap_size=args.submap_size)
            for r in range(args.robots)]
        edges = submap_mod.coarsen_edges(edges, assigns, args.steps)
        ppr = max(a.n_submaps for a in assigns)
        stages["submaps_s"] = backend.synced_clock(dev) - t
        print(f"[run] coarsened to <= {ppr} submaps/robot "
              f"({args.robots * args.steps} -> "
              f"{sum(a.n_submaps for a in assigns)} optimized poses)",
              file=sys.stderr)

        def expand_fn(params_sm):
            Rs, ts = [], []
            for r in range(args.robots):
                Rr, tr = submap_mod.expand_solution(
                    params_sm.R, params_sm.t, assigns[r], r * ppr)
                Rs.append(Rr)
                ts.append(tr)
            return pgo.PgoParams(R=torch.cat(Rs), t=torch.cat(ts))

    print("[run] back-end optimization...", file=sys.stderr)
    params, weights, dpgo_rows, info = _optimize_backend(
        args, edges, args.robots, ppr, t_start)
    stages["pcm_s"] = info.pop("pcm_s")
    stages["robust_pgo_s"] = info.pop("robust_pgo_s")
    backend_out = dict(info, edges=edges, weights=weights, params=params)
    # expand submap anchors back to keyframes before logging
    # (processOptimizedPath)
    if expand_fn is not None:
        params = expand_fn(params)

    t = backend.synced_clock(dev)
    results = write_logs(args, world, fe, params, weights, dpgo_rows)
    stages["logs_s"] = backend.synced_clock(dev) - t
    return dict(ape=results, n_opt_poses=args.robots * ppr,
                n_keyframes=args.robots * args.steps, stages=stages,
                frontend=fe_stats, loops=fe.loops, backend=backend_out)


def _optimize_backend(args, edges, n_robots, ppr, t_start):
    """The single-device robust PGO back-end over `edges` (the JAX
    package's `_optimize_backend(sharded=False)`): odometry
    initialization, then `robust_pgo`. Returns (params, weights,
    dpgo_rows, info) with `info` from `robust_pgo`."""
    from ..solve import pgo, robust

    params0 = pgo.init_from_odometry(edges, n_robots, ppr)
    info = {}
    params, gstate = robust.robust_pgo(
        params0, edges, ppr, gnc_outer_iters=args.gnc_rounds, info=info)
    dpgo_rows = [dict(robot_id=0, instance=0, iteration=0,
                      num_poses=n_robots * ppr, bytes_received=0,
                      iteration_time_sec=0.0,
                      total_time_sec=time.time() - t_start, rel_change=0.0,
                      func_decrease=0.0, grad_norm=0.0,
                      num_active_robots=n_robots)]
    return params, gstate.weights, dpgo_rows, info


def write_logs(args, world, fe, params, weights, dpgo_rows):
    """The reference-schema log tree and `ape_robot<r>.csv` per robot;
    returns {robot: ApeResult}."""
    import numpy as np
    import torch

    from ..core import lie
    from ..eval import ape as ape_mod
    from ..io import logs

    os.makedirs(args.log_dir, exist_ok=True)
    T = args.steps
    dev = params.R.device
    q_all = lie.rot_to_quat(params.R).cpu().numpy()
    t_all = params.t.cpu().numpy()
    # every loop's quaternion at once, on the host
    q_loops = (lie.rot_to_quat(torch.from_numpy(np.stack(
        [np.asarray(lc.R, np.float32) for lc in fe.loops]))).numpy()
        if fe.loops else np.zeros((0, 4), np.float32))
    final_idx = args.gnc_rounds // max(args.dump_every, 1) + 1
    results = {}
    for r in range(args.robots):
        rdir = os.path.join(args.log_dir, f"robot{r}")
        sl = slice(r * T, (r + 1) * T)
        q_est, t_est = q_all[sl], t_all[sl]
        ts = world.timestamps[r]
        logs.write_tum(
            os.path.join(rdir, "distributed",
                         f"kimera_distributed_poses_tum_{final_idx}.tum"),
            ts, t_est, q_est)
        # keyframes csv (odometry frame)
        logs.write_keyframes_csv(
            os.path.join(rdir, "distributed",
                         "kimera_distributed_keyframes.csv"),
            [dict(keyframe_id=k, keyframe_stamp_ns=int(ts[k] * 1e9),
                  tx=float(t_est[k, 0]), ty=float(t_est[k, 1]),
                  tz=float(t_est[k, 2]), qx=float(q_est[k, 0]),
                  qy=float(q_est[k, 1]), qz=float(q_est[k, 2]),
                  qw=float(q_est[k, 3]))
             for k in range(T)])
        # loop closures owned by this robot (robot_a == r)
        rows = []
        for lc, q in zip(fe.loops, q_loops):
            if lc.robot_a != r:
                continue
            rows.append(dict(
                robot1=lc.robot_a, pose1=lc.frame_a, robot2=lc.robot_b,
                pose2=lc.frame_b, qx=float(q[0]), qy=float(q[1]),
                qz=float(q[2]), qw=float(q[3]), tx=float(lc.t[0]),
                ty=float(lc.t[1]), tz=float(lc.t[2]),
                norm_bow_score=lc.bow_score,
                mono_inliers=lc.mono_inliers,
                stereo_inliers=lc.stereo_inliers,
                stamp_ns=int(world.timestamps[r, lc.frame_a] * 1e9)))
        logs.write_loop_closures_csv(
            os.path.join(rdir, "distributed", "loop_closures.csv"), rows)
        logs.write_lcd_status_csv(
            os.path.join(rdir, "single", "output_lcd_status.csv"),
            [dict(lcd_status=_status_name(lc.status), query_id=lc.frame_a,
                  match_id=lc.frame_b, mono_inliers=lc.mono_inliers,
                  stereo_inliers=lc.stereo_inliers)
             for lc in fe.lcd_attempts if lc.robot_a == r])
        logs.write_lcd_attempts_csv(
            os.path.join(rdir, "distributed", "lcd_attempts.csv"),
            [dict(robot_a=lc.robot_a, frame_a=lc.frame_a,
                  robot_b=lc.robot_b, frame_b=lc.frame_b,
                  lcd_status=_status_name(lc.status),
                  mono_inliers=lc.mono_inliers,
                  stereo_inliers=lc.stereo_inliers,
                  norm_bow_score=lc.bow_score)
             for lc in fe.lcd_attempts if lc.robot_a == r])
        logs.write_dpgo_log_csv(
            os.path.join(rdir, "distributed", "dpgo_log_0.csv"), dpgo_rows)

        # APE against the ground truth (evo_real_time.py's role)
        res = ape_mod.ape(
            params.t[sl], params.R[sl],
            torch.from_numpy(np.asarray(world.t_gt[r], np.float32)).to(dev),
            torch.from_numpy(np.asarray(world.R_gt[r], np.float32)).to(dev),
            align=True)
        results[r] = res
        with open(os.path.join(args.log_dir, f"ape_robot{r}.csv"), "w") as f:
            f.write("timestamp,rmse_trans,rmse_full,n_matched\n")
            f.write(f"{time.time()},{res.rmse_trans},{res.rmse_full},"
                    f"{res.n_matched}\n")
        print(f"[run] robot {r}: APE trans RMSE = {res.rmse_trans:.4f} m "
              f"(full {res.rmse_full:.4f})", file=sys.stderr)
    return results


def _odometry_poses(world):
    """Every robot's odometry chain composed from the identity on the
    host: (R (Rb, T, 3, 3), t (Rb, T, 3)) float32 keyframe poses in the
    odometry frame."""
    import numpy as np
    import torch

    from ..core import lie

    R_odo = torch.from_numpy(np.asarray(world.R_odo, np.float32))
    t_odo = torch.from_numpy(np.asarray(world.t_odo, np.float32))
    Rb, Tm1 = R_odo.shape[:2]
    R = torch.eye(3).expand(Rb, 3, 3)
    t = torch.zeros((Rb, 3))
    Rs, ts = [R], [t]
    for k in range(Tm1):
        R, t = lie.se3_compose(R, t, R_odo[:, k], t_odo[:, k])
        Rs.append(R)
        ts.append(t)
    return (torch.stack(Rs, dim=1).numpy(), torch.stack(ts, dim=1).numpy())


def _status_name(code):
    from ..core.containers import LCD_STATUS_NAMES

    return LCD_STATUS_NAMES.get(int(code), "UNKNOWN")


if __name__ == "__main__":
    main()
