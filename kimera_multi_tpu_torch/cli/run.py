"""End-to-end run entry point of the port (the JAX package's cli/run.py:
its `sim`, `sim-sharded`, `vio-sim` and `euroc` modes, with the
single-device or the sharded back-end).

    python -m kimera_multi_tpu_torch.cli.run --mode sim --robots 2 \
        --steps 30 --features 64 --seed 1 --log-dir LOGS [--device cpu] \
        [--save-obs OBS] [--artifacts] [--frontend sequential]
    python -m kimera_multi_tpu_torch.cli.run --mode vio-sim --robots 2 \
        --steps 16 --seed 0 --log-dir LOGS [--vio-width 640 \
        --vio-height 480 --vio-features 300 --vio-window 25] [--device cpu] \
        [--lc-images DIST_M]
    python -m kimera_multi_tpu_torch.cli.run --mode euroc \
        --euroc-roots SESSION0 SESSION1 ROBOT2.bag --steps 60 \
        --log-dir LOGS [--device cpu]
    python -m kimera_multi_tpu_torch.cli.run --mode sim-sharded \
        --robots 2 --steps 30 --features 64 --log-dir LOGS [--device cpu] \
        [--dump-every 10] [--checkpoint CKPT.npz] [--resume CKPT.npz] \
        [--profile DIR] [--chain-refine]
    torchrun --standalone --nproc-per-node N \
        -m kimera_multi_tpu_torch.cli.run --mode sim-sharded --robots 6 \
        ... [--device cpu]   (N ranks, N dividing the fleet)

sim: synthetic sensor world -> vocabulary -> batched front-end (BoW
detection, RANSAC verification) -> pose graph (optionally coarsened to
submaps) -> PCM + GNC robust PGO -> reference-schema logs + APE per robot.
vio-sim: the same from pixels: a rendered stereo + IMU sequence -> one
VIO pipeline per robot over its staggered frame window (tracking,
preintegration, outlier rejection, fixed-lag smoother) -> the batched
front-end on the keyframes' descriptors, bearings and landmarks -> pose
graph from the VIO odometry and the loops -> PCM + GNC robust PGO -> logs
+ APE against ground truth at keyframe times.
euroc: recorded sessions, one per robot (EuRoC ASL trees, or rosbag1
files extracted to ASL trees under LOGS/bags/): the VIO pipeline over each
session's first `--steps` frames (io/convert.py) -> the batched front-end
-> pose graph from the VIO odometry -> PCM + GNC robust PGO -> logs + APE
against each session's ground truth (suppressed for a session without).
`--save-obs DIR` (sim) writes each robot's observation stream for the
replay gate (cli/replay.py).
sim-sharded (or `--backend sharded` in vio-sim and euroc): the back-end as
bulk-synchronous RBCD rounds over a robot group (dist/): PCM consensus,
lifting, `--gnc-rounds` rounds with GNC reweighting every 2nd round from
round 8, a trajectory dump every `--dump-every` rounds (numbered by the
global round, so a resumed run continues the numbering), rounding, the
gauge and a Gauss-Newton polish. The group is the default process group
when one is initialised, else one made from the environment under a
launcher such as torchrun (rank k on cuda:LOCAL_RANK, or gloo ranks with
`--device cpu`; rank k > 0 writes its logs under LOGS/rank<k>), else one
rank in this process (NCCL on the card, gloo on the CPU). `--checkpoint PATH` saves the round state
at every dump and `--resume PATH` continues from one (the JAX package's
file format); `--profile DIR` traces the rounds with torch.profiler
(DIR/trace.json, DIR/profile_summary.json); `--chain-refine` re-solves
every translation with the chain-sharded solver after the polish.
Every mode runs on the card unless `--device cpu` is given; asking for the
card where there is none raises.

Outputs under --log-dir follow the reference contract:
  robot<r>/distributed/kimera_distributed_poses_tum_<k>.tum
  robot<r>/distributed/loop_closures.csv
  robot<r>/distributed/kimera_distributed_keyframes.csv
  robot<r>/distributed/lcd_attempts.csv
  robot<r>/distributed/dpgo_log_0.csv
  robot<r>/single/output_lcd_status.csv
  ape_robot<r>.csv

`--artifacts` (sim) adds surface.ply, mesh.ply and run.html;
`--frontend sequential` (sim) takes the per-keyframe front-end;
`--lc-images DIST_M` (vio-sim) writes lc_images/*.png and a manifest.
A flag another mode or back-end reads is accepted and ignored, with a
note.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _sharded(args) -> bool:
    """Whether the run takes the sharded back-end, as in the JAX package:
    `--mode sim-sharded`, or `--backend sharded` in the vio-sim and euroc
    modes (`args` may be any namespace: a missing mode or back-end is the
    single-device sim)."""
    mode = getattr(args, "mode", "sim")
    if mode in ("sim", "sim-sharded"):
        return mode == "sim-sharded"
    return getattr(args, "backend", "single") == "sharded"


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
                   help="sharded back-end: a trajectory dump (and the "
                        "checkpoint) every this many rounds; the final "
                        "trajectory is kimera_distributed_poses_tum_<rounds "
                        "// dump_every + 1>.tum")
    p.add_argument("--submap-size", type=int, default=0,
                   help="coarsen the back-end graph to submaps of up to "
                        "this many keyframes (0 = keyframe level)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--frontend", choices=["batched", "sequential"],
                   default="batched",
                   help="sim: batched (detection loop, then verification "
                        "in chunks) or sequential (one keyframe at a time, "
                        "each gated pair verified alone; the same loops)")
    p.add_argument("--artifacts", action="store_true",
                   help="sim: write surface.ply, mesh.ply and run.html "
                        "(TSDF, marching tetrahedra, deformation graph)")
    p.add_argument("--checkpoint", default=None,
                   help="sharded back-end: save the round state here at "
                        "every dump")
    p.add_argument("--resume", default=None,
                   help="sharded back-end: continue from a round-state "
                        "checkpoint")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="sharded back-end: trace the rounds with "
                        "torch.profiler into DIR (trace.json, "
                        "profile_summary.json)")
    p.add_argument("--chain-refine", action="store_true",
                   help="sharded back-end: after rounding and the polish, "
                        "re-solve every translation with the chain-sharded "
                        "solver")
    p.add_argument("--save-obs", default=None,
                   help="sim: write each robot's observation stream "
                        "(obs_robot<k>.npz) here for cli/replay.py")
    p.add_argument("--euroc-roots", nargs="+", default=None,
                   help="euroc: one recorded session per robot, an EuRoC "
                        "ASL directory (containing mav0/) or a rosbag1 "
                        "file")
    p.add_argument("--lc-images", type=float, default=None,
                   metavar="DIST_M",
                   help="vio-sim: write side-by-side image evidence of the "
                        "loop closures whose ground-truth keyframe distance "
                        "exceeds this many metres (reference threshold 30)")
    p.add_argument("--vio-width", type=int, default=128,
                   help="vio-sim: rendered image width (reference "
                        "envelope 640)")
    p.add_argument("--vio-height", type=int, default=96,
                   help="vio-sim: rendered image height (reference "
                        "envelope 480)")
    p.add_argument("--vio-features", type=int, default=96,
                   help="vio-sim: VIO feature budget (reference envelope "
                        "300, maxFeaturesPerFrame)")
    p.add_argument("--vio-window", type=int, default=8,
                   help="vio-sim: smoother window size (reference "
                        "envelope 25 keyframes)")
    args = p.parse_args(argv)

    # flags another mode reads; the JAX package ignores them silently
    for flag, on, mode in (
            ("--save-obs", args.save_obs, "sim"),
            ("--artifacts", args.artifacts, "sim"),
            ("--frontend sequential", args.frontend != "batched", "sim"),
            ("--lc-images", args.lc_images is not None, "vio-sim")):
        if on and args.mode != mode:
            print(f"[run] {flag} is read by --mode {mode} only; ignored",
                  file=sys.stderr)
    if args.mode == "sim" and args.backend == "sharded":
        print("[run] --backend is read by --mode vio-sim and euroc only "
              "(--mode sim-sharded takes the sharded back-end); ignored",
              file=sys.stderr)
    if "LOCAL_RANK" in os.environ and args.device == "cuda":
        # one rank a card under a launcher such as torchrun
        args.device = f"cuda:{os.environ['LOCAL_RANK']}"
    if not _sharded(args):
        for flag, on in (("--checkpoint", args.checkpoint),
                         ("--resume", args.resume),
                         ("--profile", args.profile),
                         ("--chain-refine", args.chain_refine)):
            if on:
                print(f"[run] {flag} is read by the sharded back-end only "
                      "(--mode sim-sharded or --backend sharded); ignored",
                      file=sys.stderr)
    if args.mode == "vio-sim":
        return run_vio_sim(args)
    if args.mode == "euroc":
        return run_euroc(args)
    return run_sim(args)


def run_sim(args):
    """The `sim` mode. Returns dict(ape, n_opt_poses, n_keyframes) as the
    JAX package's run_sim does, and besides: `stages` (seconds on a
    synchronised clock: front-end, build_pose_graph, submaps, pcm,
    robust_pgo, logs; save_obs with `--save-obs`, artifacts with
    `--artifacts`), `frontend` (the front-end's stats), `loops` (the
    accepted `VerifiedLC` records), `backend` (the pose graph `edges`,
    PCM's `consensus` and `frame_ok`, the final `weights` and `params`,
    before any submap expansion) and, with `--artifacts`, `artifacts`
    (`write_artifacts`'s result)."""
    import torch

    from ..core import backend
    from ..frontend import batched, dlc, vocab as vocab_mod
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
    t = backend.synced_clock(dev)
    if args.frontend == "batched":
        fe = batched.BatchedFrontend(args.robots, args.steps, voc, cfg,
                                     device=dev)
        print("[run] front-end (batched detect + verify)...",
              file=sys.stderr)
        fe_stats = fe.process_all(world.descriptors, world.bearings_local,
                                  world.landmarks_local, world.obs_valid)
    else:
        fe = dlc.DistributedFrontend(args.robots, args.steps, voc, cfg,
                                     device=dev)
        print("[run] front-end (sequential host loop)...", file=sys.stderr)
        fe_stats = fe.process_all(world.descriptors, world.bearings_local,
                                  world.landmarks_local, world.obs_valid)
    stages["frontend_s"] = backend.synced_clock(dev) - t
    print(f"[run] committed loop closures: {len(fe.loops)} (attempts "
          f"{len(fe.lcd_attempts)})", file=sys.stderr)

    if args.save_obs:
        from ..io import replay as replay_mod

        t = time.perf_counter()
        for r in range(args.robots):
            replay_mod.save_observations(
                replay_mod.obs_path(args.save_obs, r),
                replay_mod.ObservationStream(
                    descriptors=world.descriptors[r],
                    bearings=world.bearings_local[r],
                    landmarks=world.landmarks_local[r],
                    valid=world.obs_valid[r],
                    timestamps=world.timestamps[r]))
        stages["save_obs_s"] = time.perf_counter() - t
        print(f"[run] observation streams saved to {args.save_obs}",
              file=sys.stderr)

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
        args, edges, args.robots, ppr, t_start, world, expand_fn)
    _move_times(info, stages)
    backend_out = dict(info, edges=edges, weights=weights, params=params)
    # expand submap anchors back to keyframes before logging
    # (processOptimizedPath)
    if expand_fn is not None:
        params = expand_fn(params)

    t = backend.synced_clock(dev)
    results = write_logs(args, world, fe, params, weights, dpgo_rows,
                         final_idx=info.get("final_idx"))
    stages["logs_s"] = backend.synced_clock(dev) - t
    out = dict(ape=results, n_opt_poses=args.robots * ppr,
               n_keyframes=args.robots * args.steps, stages=stages,
               frontend=fe_stats, loops=fe.loops, backend=backend_out)
    if args.artifacts:
        t = backend.synced_clock(dev)
        out["artifacts"] = write_artifacts(args, world, params)
        stages["artifacts_s"] = backend.synced_clock(dev) - t
    return out


class _VioWorld:
    """World-shaped view of the per-robot VIO keyframe products, so that
    the vio-sim run reuses write_logs (timestamps and ground truth at
    keyframe times)."""

    def __init__(self, timestamps, t_gt, R_gt, R_odo, t_odo):
        self.timestamps = timestamps  # (R, T)
        self.t_gt = t_gt  # (R, T, 3)
        self.R_gt = R_gt  # (R, T, 3, 3)
        self.R_odo = R_odo  # (R, T-1, 3, 3)
        self.t_odo = t_odo  # (R, T-1, 3)


def vio_sim_config(width: int, height: int, features: int, window: int):
    """The vio-sim run's VIO `PipelineConfig` for a rendered rig of this
    size: focal 0.86 x width, the stereo baseline 0.2 m, every frame a
    keyframe, 200 RANSAC hypotheses, 12 Gauss-Newton iterations."""
    from ..vio import imu, pipeline, smoother, tracking
    from ..vio.undistort import CameraModel

    W, H = width, height
    return pipeline.PipelineConfig(
        cam=CameraModel(fx=0.86 * W, fy=0.86 * W, cx=W / 2, cy=H / 2),
        baseline=0.2, window_size=window, max_features=features,
        gftt=tracking.GfttParams(max_features=features,
                                 min_distance=max(6, W // 21),
                                 quality_level=0.001),
        klt=tracking.KltParams(win_size=12 if W <= 256 else 24,
                               max_level=3, max_iter=20),
        min_intra_keyframe_time=0.0, disparity_threshold=0.0,
        ransac_iterations=200, min_mono_inliers=8, min_stereo_inliers=4,
        vio=smoother.VioConfig(gn_iters=12),
        imu=imu.ImuParams(gyro_noise=2e-3, accel_noise=2e-2))


def run_vio_sim(args):
    """The `vio-sim` mode: VIO -> loop-closure front-end -> robust PGO from
    pixels. All robots traverse the same rendered scene on one arc with
    staggered frame windows (half a window apart), so later robots revisit
    earlier robots' places.

    Returns dict(ape, n_keyframes, n_loops, n_inter_loops, frontend_stats)
    as the JAX package's run_vio_sim does, and besides: `stages` (seconds
    on a synchronised clock: render, vio, frontend, build_pose_graph,
    pcm, robust_pgo, logs, lc_images with `--lc-images`; `vio_frame_s`,
    each keyframe-making frame's time), `rejection_logs` (each robot's
    `RejectionStats` per keyframe), `loops`, `bow_weight_span` (the
    largest ratio of a keyframe BoW vector's largest to smallest nonzero
    weight; detection on the card equals the CPU's while it stays under
    2^22, kernels/bow.py), `gt` (R, t at keyframe times and `idx`, each
    keyframe's rendered frame) and `lc_images` (the PNGs written with
    `--lc-images`, else None)."""
    import numpy as np

    from ..core import backend
    from ..frontend import batched, vocab as vocab_mod
    from ..frontend.dlc import FrontendConfig
    from ..io import render as render_mod
    from ..io.convert import check_keyframes
    from ..vio import pipeline as vio_pipeline

    dev = backend.resolve_device(args.device)
    t_start = time.time()
    stages = {}
    Rn, F = args.robots, args.steps
    # --vio-width 640 --vio-height 480 --vio-features 300 --vio-window 25
    # is the reference envelope (params/D455)
    H, W = args.vio_height, args.vio_width
    feats = args.vio_features
    cfg = vio_sim_config(W, H, feats, args.vio_window)
    rig = render_mod.StereoRig(cam=cfg.cam, H=H, W=W, baseline=cfg.baseline)
    # 50 % window overlap between consecutive robots: revisits
    stride = max(F // 2, 1)
    F_total = stride * (Rn - 1) + F
    print(f"[run] rendering {F_total} stereo frames ({Rn} robots x {F} "
          f"frames, {W}x{H}, {feats} features, stride {stride})",
          file=sys.stderr)
    t = backend.synced_clock(dev)
    scene = render_mod.make_scene(seed=args.seed,
                                  n_points=max(350, 4 * feats))
    seq = render_mod.render_sequence(
        scene, rig, n_frames=F_total, rate_hz=10.0, imu_rate_hz=100.0,
        speed=0.6, yaw_rate=0.1, device=dev)
    stages["render_s"] = backend.synced_clock(dev) - t

    # ---- per-robot VIO over its frame window -------------------------
    K = cfg.max_features
    kf_all, rejection_logs, frame_s = [], [], []
    t = backend.synced_clock(dev)
    for r in range(Rn):
        o = r * stride
        vio = vio_pipeline.VioPipeline(cfg, device=dev)
        imu_i = int(np.searchsorted(seq.imu_ts, seq.timestamps[o],
                                    side="right"))
        n_kf = 0
        for k in range(o, o + F):
            ts = seq.timestamps[k]
            while imu_i < len(seq.imu_ts) and seq.imu_ts[imu_i] <= ts:
                vio.add_imu(seq.imu_ts[imu_i], seq.gyro[imu_i],
                            seq.accel[imu_i])
                imu_i += 1
            tf = time.perf_counter()
            # a keyframe ends in host reads of its results: synchronised
            kf = vio.process_frame(ts, seq.left[k], seq.right[k])
            if kf is not None:
                frame_s.append(time.perf_counter() - tf)
                n_kf += 1
        # the FINAL keyframe states, not the snapshots process_frame
        # returned: gravity alignment (keyframe 0) and every window
        # re-solve replace entries of vio.keyframes with refined poses
        check_keyframes(vio, n_kf, f"robot {r}")
        kf_all.append(list(vio.keyframes))
        rejection_logs.append(list(vio.rejection_log))
        print(f"[run] robot {r}: VIO produced {n_kf} keyframes "
              f"(frames {o}..{o + F - 1})", file=sys.stderr)
    stages["vio_s"] = backend.synced_clock(dev) - t
    stages["vio_frame_s"] = frame_s

    T = min(len(k) for k in kf_all)  # uniform horizon across the fleet
    kf_all = [k[:T] for k in kf_all]

    # ---- keyframe products -> the loop-closure front-end -------------
    desc = np.zeros((Rn, T, K, 32), np.uint8)
    bear = np.zeros((Rn, T, K, 3), np.float32)
    lm = np.zeros((Rn, T, K, 3), np.float32)
    val = np.zeros((Rn, T, K), bool)
    ts_kf = np.zeros((Rn, T), np.float64)
    for r, kfs in enumerate(kf_all):
        for k, kf in enumerate(kfs):
            desc[r, k] = kf.descriptors
            bear[r, k] = kf.bearings
            lm[r, k] = kf.landmarks
            val[r, k] = kf.valid & kf.lm_valid
            ts_kf[r, k] = kf.timestamp

    corpus = desc[val].reshape(-1, 32)
    sub = corpus[:: max(1, len(corpus) // 4000)]
    voc = vocab_mod.build_vocabulary(sub, k=8, depth=3, seed=args.seed,
                                     device=dev)
    fe = batched.BatchedFrontend(Rn, T, voc,
                                 FrontendConfig(base_seed=args.seed),
                                 device=dev)
    print("[run] front-end (batched detect + verify) on VIO keyframes...",
          file=sys.stderr)
    t = backend.synced_clock(dev)
    stats = fe.process_all(desc, bear, lm, val)
    stages["frontend_s"] = backend.synced_clock(dev) - t
    n_inter = sum(1 for lc in fe.loops if lc.robot_a != lc.robot_b)
    print(f"[run] committed loop closures: {len(fe.loops)} ({n_inter} "
          f"inter-robot; attempts {len(fe.lcd_attempts)})", file=sys.stderr)
    span = _bow_weight_span(fe, desc, val)

    # ---- odometry edges from the VIO keyframe estimates --------------
    R_odo, t_odo = _odometry_edges(
        [np.stack([kf.R for kf in kfs]) for kfs in kf_all],
        [np.stack([kf.t for kf in kfs]) for kfs in kf_all])
    t = backend.synced_clock(dev)
    edges = fe.build_pose_graph(R_odo, t_odo)
    stages["build_pose_graph_s"] = backend.synced_clock(dev) - t

    # ground truth at keyframe times (the APE contract)
    gt_idx = np.clip(np.searchsorted(seq.timestamps, ts_kf), 0,
                     F_total - 1)
    world = _VioWorld(timestamps=ts_kf, t_gt=seq.t_gt[gt_idx],
                      R_gt=seq.R_gt[gt_idx], R_odo=R_odo, t_odo=t_odo)
    args.steps = T  # write_logs and the round dumps slice by T
    print(f"[run] back-end optimization ({_backend_name(args)})...",
          file=sys.stderr)
    params, weights, dpgo_rows, info = _optimize_backend(
        args, edges, Rn, T, t_start, world)
    _move_times(info, stages)

    # ---- loop-closure image evidence (extract_lc_images) -------------
    lc_images = None
    if args.lc_images is not None:
        from ..eval import lc_forensics

        t = time.perf_counter()
        rows = []
        for lc in fe.loops:
            g1 = int(gt_idx[lc.robot_a, lc.frame_a])
            g2 = int(gt_idx[lc.robot_b, lc.frame_b])
            rows.append(dict(
                robot1=lc.robot_a, pose1=lc.frame_a, robot2=lc.robot_b,
                pose2=lc.frame_b,
                gt_distance=float(np.linalg.norm(seq.t_gt[g1]
                                                 - seq.t_gt[g2])),
                mono_inliers=lc.mono_inliers,
                stereo_inliers=lc.stereo_inliers))
        lc_images = lc_forensics.extract_lc_images(
            rows, lambda r, f: seq.left[int(gt_idx[r, f])],
            os.path.join(args.log_dir, "lc_images"),
            threshold=args.lc_images)
        stages["lc_images_s"] = time.perf_counter() - t
        print(f"[run] lc image evidence: {len(lc_images)} annotated pairs "
              f"-> {args.log_dir}/lc_images", file=sys.stderr)

    t = backend.synced_clock(dev)
    results = write_logs(args, world, fe, params, weights, dpgo_rows,
                         final_idx=info.get("final_idx"))
    stages["logs_s"] = backend.synced_clock(dev) - t
    return dict(ape=results, n_keyframes=Rn * T, n_loops=len(fe.loops),
                n_inter_loops=n_inter, frontend_stats=stats, stages=stages,
                rejection_logs=rejection_logs, loops=fe.loops,
                bow_weight_span=span,
                backend=dict(info, edges=edges, weights=weights,
                             params=params),
                gt=dict(R=world.R_gt, t=world.t_gt, idx=gt_idx),
                lc_images=lc_images)


def _bow_weight_span(fe, desc, val) -> float:
    """The largest ratio of a keyframe BoW vector's largest to smallest
    nonzero weight (detection on the card equals the CPU's while it stays
    under 2^22, kernels/bow.py)."""
    import numpy as np

    bow_w = fe.compute_bows(desc, val)[1]
    nz = bow_w > 0
    has = nz.any(-1)
    return float((np.where(nz, bow_w, 0).max(-1)[has]
                  / np.where(nz, bow_w, np.inf).min(-1)[has]).max()
                 ) if has.any() else 0.0


def _odometry_edges(R_kf: list, t_kf: list):
    """Relative poses of consecutive keyframes from each robot's keyframe
    poses (R (T, 3, 3), t (T, 3) world <- body): (R_odo (Rn, T-1, 3, 3),
    t_odo (Rn, T-1, 3)) float32."""
    import numpy as np

    Rn, T = len(R_kf), len(R_kf[0])
    R_odo = np.zeros((Rn, T - 1, 3, 3), np.float32)
    t_odo = np.zeros((Rn, T - 1, 3), np.float32)
    for r, (Ra, ta) in enumerate(zip(R_kf, t_kf)):
        R_odo[r] = np.einsum("kji,kjl->kil", Ra[:-1], Ra[1:])
        t_odo[r] = np.einsum("kji,kj->ki", Ra[:-1], ta[1:] - ta[:-1])
    return R_odo, t_odo


def run_euroc(args):
    """The `euroc` mode: recorded sessions -> VIO -> loop-closure
    front-end -> robust PGO, one session per robot (BASELINE.json config
    4: EuRoC multi-session as pseudo-multi-robot). `.bag` roots are
    extracted to ASL trees under `<log-dir>/bags/` first; each session's
    first `--steps` frames (all with `--steps 0`) run through the VIO
    pipeline (io/convert.py); the fleet keeps the shortest session's
    keyframe count. APE is taken against each session's ground truth at
    keyframe times and suppressed for a session without.

    Returns dict(ape, n_keyframes, n_loops, n_inter_loops) as the JAX
    package's run_euroc does, and besides: `stages` (seconds: bags,
    io (image files), vio (the pipelines, synchronised), frontend,
    build_pose_graph, pcm, robust_pgo, logs; `vio_frame_s`, each
    keyframe-making frame's time), `rejection_logs`, `loops`,
    `bow_weight_span`, `backend`, `gt` (R, t, mask) and `observations`
    (each session's whole ObservationStream, before the common horizon
    cuts it)."""
    import numpy as np
    import torch

    from ..core import backend, lie
    from ..frontend import batched, vocab as vocab_mod
    from ..frontend.dlc import FrontendConfig
    from ..io import convert as convert_mod

    if not args.euroc_roots:
        raise SystemExit("--mode euroc requires --euroc-roots")
    dev = backend.resolve_device(args.device)
    t_start = time.time()
    stages = dict(bags_s=0.0, io_s=0.0, vio_s=0.0, vio_frame_s=[])
    Rn = len(args.euroc_roots)
    max_frames = args.steps or None
    say = lambda m: print(f"[run] {m}", file=sys.stderr)  # noqa: E731
    streams, rejection_logs = [], []
    for r, root in enumerate(args.euroc_roots):
        # .bag roots become ASL trees first (io/rosbag.py)
        t = time.perf_counter()
        root = convert_mod.resolve_session_root(
            root, os.path.join(args.log_dir, "bags"), r,
            max_frames=max_frames, log=say)
        stages["bags_s"] += time.perf_counter() - t
        st = {}
        obs, sess, (R_kf, t_kf) = convert_mod.euroc_to_observations(
            root, max_frames=max_frames, log=say, device=dev, stats=st)
        stages["io_s"] += st["io_s"]
        stages["vio_s"] += st["vio_s"]
        stages["vio_frame_s"] += st["frame_s"]
        rejection_logs.append(st["rejection_log"])
        streams.append((obs, sess, R_kf, t_kf))
        say(f"robot {r}: {root} -> {obs.descriptors.shape[0]} keyframes")

    T = min(s[0].descriptors.shape[0] for s in streams)
    desc = np.stack([s[0].descriptors[:T] for s in streams])
    bear = np.stack([s[0].bearings[:T] for s in streams])
    lm = np.stack([s[0].landmarks[:T] for s in streams])
    val = np.stack([s[0].valid[:T] for s in streams])
    ts_kf = np.stack([s[0].timestamps[:T] for s in streams])

    corpus = desc[val].reshape(-1, 32)
    sub = corpus[:: max(1, len(corpus) // 4000)]
    voc = vocab_mod.build_vocabulary(sub, k=8, depth=3, seed=args.seed,
                                     device=dev)
    fe = batched.BatchedFrontend(Rn, T, voc,
                                 FrontendConfig(base_seed=args.seed),
                                 device=dev)
    say("front-end (batched detect + verify) on EuRoC keyframes...")
    t = backend.synced_clock(dev)
    fe_stats = fe.process_all(desc, bear, lm, val)
    stages["frontend_s"] = backend.synced_clock(dev) - t
    n_inter = sum(1 for lc in fe.loops if lc.robot_a != lc.robot_b)
    say(f"committed loop closures: {len(fe.loops)} ({n_inter} inter-robot)")
    span = _bow_weight_span(fe, desc, val)

    R_odo, t_odo = _odometry_edges([s[2][:T] for s in streams],
                                   [s[3][:T] for s in streams])
    t = backend.synced_clock(dev)
    edges = fe.build_pose_graph(R_odo, t_odo)
    stages["build_pose_graph_s"] = backend.synced_clock(dev) - t

    # ground truth at keyframe times, from the sessions'
    # state_groundtruth files (the first sample at or after the keyframe);
    # a robot whose session has none gets gt_mask False and no APE
    R_gt = np.broadcast_to(np.eye(3, dtype=np.float32), (Rn, T, 3, 3)).copy()
    t_gt = np.zeros((Rn, T, 3), np.float32)
    gt_mask = [len(s[1].gt_ts) > 0 for s in streams]
    for r, (_, sess, _, _) in enumerate(streams):
        if not gt_mask[r]:
            continue
        gi = np.clip(np.searchsorted(sess.gt_ts, ts_kf[r]), 0,
                     len(sess.gt_ts) - 1)
        t_gt[r] = sess.gt_t[gi]
        R_gt[r] = lie.quat_to_rot(torch.from_numpy(sess.gt_q[gi])).numpy()

    world = _VioWorld(timestamps=ts_kf, t_gt=t_gt, R_gt=R_gt, R_odo=R_odo,
                      t_odo=t_odo)
    args.steps = T  # write_logs and the round dumps slice by T
    args.robots = Rn
    say(f"back-end optimization ({_backend_name(args)})...")
    params, weights, dpgo_rows, info = _optimize_backend(
        args, edges, Rn, T, t_start, world)
    _move_times(info, stages)
    t = backend.synced_clock(dev)
    results = write_logs(args, world, fe, params, weights, dpgo_rows,
                         gt_mask=gt_mask, final_idx=info.get("final_idx"))
    stages["logs_s"] = backend.synced_clock(dev) - t
    return dict(ape=results, n_keyframes=Rn * T, n_loops=len(fe.loops),
                n_inter_loops=n_inter, frontend_stats=fe_stats,
                stages=stages, rejection_logs=rejection_logs,
                loops=fe.loops, bow_weight_span=span,
                backend=dict(info, edges=edges, weights=weights,
                             params=params),
                gt=dict(R=R_gt, t=t_gt, mask=gt_mask),
                observations=[s[0] for s in streams])


def _backend_name(args) -> str:
    return ("sharded robot-group rounds" if _sharded(args)
            else "single device")


def _move_times(info: dict, stages: dict) -> None:
    """Move the back-end's times (the `*_s` entries of its info) into the
    run's stages."""
    for k in [k for k in info if k.endswith("_s")]:
        stages[k] = info.pop(k)


def _optimize_backend(args, edges, n_robots, ppr, t_start, world=None,
                      expand_fn=None):
    """The back-end over `edges` (the JAX package's `_optimize_backend`):
    odometry initialization, then `robust_pgo` on one device, or with
    `_sharded(args)` the rounds of `_optimize_sharded`. Returns (params,
    weights, dpgo_rows, info); info holds PCM's `consensus` and
    `frame_ok` and the back-end's times (`pcm_s` and `robust_pgo_s`, or
    those of `_optimize_sharded`)."""
    from ..solve import pgo, robust

    params0 = pgo.init_from_odometry(edges, n_robots, ppr)
    if _sharded(args):
        return _optimize_sharded(args, edges, n_robots, ppr, params0,
                                 t_start, world, expand_fn)
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


# the sharded back-end's schedule (the JAX package's cli/run.py): GNC
# reweighting every 2nd round from round 8, RbcdConfig()'s rounds, the
# polish's Gauss-Newton iterations and CG steps, the chain solve's CG steps
SHARDED_GNC_EVERY, SHARDED_BURNIN = 2, 8
POLISH_GN_ITERS, POLISH_CG_ITERS = 5, 40
CHAIN_CG_ITERS = 150


def _optimize_sharded(args, edges, n_robots, ppr, params0, t_start, world,
                      expand_fn):
    """The sharded back-end (the JAX package's `_optimize_backend(...,
    sharded=True)`): PCM consensus decides the inter-robot frames,
    non-consensus shared loops start at weight 0; lifting; rounds over the
    robot group with a dump every `--dump-every` rounds (and the
    checkpoint); rounding, the gauge (pose 0 at the identity) and a
    Gauss-Newton polish; with `--chain-refine` the chain solve of every
    translation.

    info: `consensus`, `frame_ok` (`rounds.lifted_start`), `Y` (the
    rounds' final blocks), `round_idx`, `comm_bytes` per round and where
    it comes from (`comm_source`: "measured" by the group's collectives
    or "analytic"), `final_idx` (the final trajectory file's index),
    `rank` and `world`, `profile` (the summary, with `--profile`), and
    the times `pcm_s` (PCM and lifting), `rounds_s`, `polish_s`
    (rounding, gauge, Gauss-Newton), `chain_refine_s`."""
    import contextlib

    import torch

    from ..core import backend, lie, stiefel
    from ..dist import checkpoint, mesh, rounds
    from ..solve import pgo, rbcd

    dev = params0.R.device
    info = {}
    t = backend.synced_clock(dev)
    Y0, w0, consensus, frame_ok = rounds.lifted_start(
        params0, edges, n_robots, ppr, args.seed)
    info.update(consensus=consensus, frame_ok=frame_ok,
                pcm_s=backend.synced_clock(dev) - t)
    rcfg = rbcd.RbcdConfig()
    say = lambda m: print(f"[run] {m}", file=sys.stderr)  # noqa: E731
    with mesh.robot_group(n_robots, dev) as group:
        info.update(rank=group.rank, world=group.world)
        say(f"robot group: rank {group.rank} of {group.world}, robots "
            f"{group.owned[0]}-{group.owned[-1]} on {group.device}")
        if group.rank:
            # every rank holds the same solution; rank 0 writes the log
            # tree, the others beside it
            args.log_dir = os.path.join(args.log_dir, f"rank{group.rank}")
        round_fn = rounds.make_round_fn(
            group, edges, ppr, rcfg, weight_update_every=SHARDED_GNC_EVERY,
            burnin_rounds=SHARDED_BURNIN)
        if args.resume:
            state = checkpoint.load(args.resume, device=dev)
            say(f"resumed from {args.resume} at round {state.round_idx}")
        else:
            state = rounds.init_state(
                Y0, torch.ones(n_robots, dtype=torch.bool, device=dev),
                edges, ppr, init_weights=w0)
        dpgo_rows = []
        comm_bytes = None
        if args.profile:
            from ..eval import profile as profile_mod

            prof = profile_mod.trace(dev)
            say(f"profiling rounds -> {args.profile}")
        t = backend.synced_clock(dev)
        with prof if args.profile else contextlib.nullcontext():
            for i in range(args.gnc_rounds):
                t0 = time.time()
                received = group.received
                state, cost = round_fn(state)
                if comm_bytes is None:
                    comm_bytes = _round_comm_bytes(
                        group.received - received, state, group, rcfg, info)
                dpgo_rows.append(dict(
                    robot_id=0, instance=0, iteration=state.round_idx - 1,
                    num_poses=n_robots * ppr,
                    bytes_received=comm_bytes * (i + 1),
                    iteration_time_sec=time.time() - t0,
                    total_time_sec=time.time() - t_start, rel_change=0.0,
                    func_decrease=float(cost), grad_norm=0.0,
                    num_active_robots=n_robots))
                if state.round_idx % args.dump_every == 0:
                    # periodic trajectory dumps (logTimerCallback),
                    # numbered by the global round
                    _dump_round_trajectories(
                        args, world, state.Y,
                        state.round_idx // args.dump_every - 1, expand_fn)
                    if args.checkpoint and group.rank == 0:
                        checkpoint.save(args.checkpoint, state)
        info["rounds_s"] = backend.synced_clock(dev) - t
        info["comm_bytes"] = comm_bytes
        if args.profile:
            info["profile"] = summary = profile_mod.write(prof, args.profile)
            for plane in summary["planes"]:
                top3 = ", ".join(f"{o['name']} {o['total_ms']}ms"
                                 for o in plane["top_ops"][:3])
                say(f"profile {plane['name']}: {plane['total_event_ms']}ms "
                    f"events; top: {top3}")
        info.update(Y=state.Y, round_idx=state.round_idx,
                    final_idx=state.round_idx // max(args.dump_every, 1) + 1)
        t = backend.synced_clock(dev)
        weights = state.gnc_state.weights
        R_all, t_all = stiefel.round_solution(
            state.Y.reshape(-1, *state.Y.shape[2:]), 3)
        # gauge (pose 0 at the identity, as the Gauss-Newton anchor), then
        # an SE(3) polish of the rounded solution
        Rg, tg = lie.se3_inverse(R_all[0], t_all[0])
        n_all = R_all.shape[0]
        R_all, t_all = lie.se3_compose(Rg.expand(n_all, 3, 3),
                                       tg.expand(n_all, 3), R_all, t_all)
        params = pgo.gauss_newton(pgo.PgoParams(R=R_all, t=t_all), edges,
                                  weights, ppr, gn_iters=POLISH_GN_ITERS,
                                  cg_iters=POLISH_CG_ITERS)
        info["polish_s"] = backend.synced_clock(dev) - t
        if args.chain_refine:
            t = backend.synced_clock(dev)
            params = pgo.PgoParams(R=params.R, t=_chain_refine(
                params, edges, ppr, weights, group))
            info["chain_refine_s"] = backend.synced_clock(dev) - t
            say("chain-refine: translations re-solved by the chain-sharded "
                f"solver over {group.world} rank(s)")
    return params, weights, dpgo_rows, info


def _round_comm_bytes(received, state, group, rcfg, info) -> int:
    """Bytes received a round: `received`, the group's count over the
    first round (reference counter: mTotalBytesReceived), or the
    analytic model where that count fails its sanity band (always on one
    rank), with the reason logged. Sets info["comm_source"]."""
    from ..dist import rounds

    try:
        n = rounds.measured_round_comm_bytes(received, state.Y.shape,
                                             group.world, rcfg.inner_iters)
        info["comm_source"] = "measured"
        return n
    except ValueError as e:
        print(f"[run] comm-byte count not usable ({e}); using the "
              "analytic model", file=sys.stderr)
        info["comm_source"] = "analytic"
        return rounds.round_comm_bytes(tuple(state.Y.shape),
                                       rcfg.inner_iters)


def _chain_refine(params, edges, ppr, weights, group,
                  cg_iters=CHAIN_CG_ITERS):
    """Exact translation recovery as one sequence-parallel solve (the JAX
    package's `_chain_refine`): given the final rotations the translation
    subproblem is linear; the fleet's pose chains are concatenated into
    one chain split over the group's ranks, with zero-weight links at the
    robot boundaries and every GNC-weighted loop closure in the coupling
    table. Warm-started at the polished translations, so a robot cut off
    from the anchor keeps its placement. Returns t (N, 3)."""
    import numpy as np
    import torch

    from ..core.containers import EDGE_ODOMETRY
    from ..dist import chain

    W = group.world
    N = params.t.shape[0]
    Np = int(np.ceil(N / W) * W)
    src, dst = (x.cpu().numpy() for x in edges.global_ids(ppr))
    et = edges.etype.cpu().numpy()
    val = edges.valid.cpu().numpy()
    w_all = (weights * edges.tau).cpu().numpy()
    R_f = params.R.cpu().numpy()
    t_meas = edges.t.cpu().numpy()

    d_chain = np.zeros((Np, 3), np.float32)
    wc = np.zeros(Np, np.float32)
    is_odo = val & (et == EDGE_ODOMETRY) & (dst == src + 1)
    oe = np.nonzero(is_odo)[0]
    d_chain[src[oe]] = np.einsum("eij,ej->ei", R_f[src[oe]], t_meas[oe])
    wc[src[oe]] = w_all[oe]

    lc = np.nonzero(val & ~is_odo & (w_all > 1e-9))[0]
    cap = max(8, int(2 ** np.ceil(np.log2(max(len(lc), 1)))))
    lc_src = np.full(cap, -1, np.int32)
    lc_dst = np.full(cap, -1, np.int32)
    lc_d = np.zeros((cap, 3), np.float32)
    lc_w = np.zeros(cap, np.float32)
    lc_src[: len(lc)] = src[lc]
    lc_dst[: len(lc)] = dst[lc]
    lc_d[: len(lc)] = np.einsum("eij,ej->ei", R_f[src[lc]], t_meas[lc])
    lc_w[: len(lc)] = w_all[lc]

    x0 = np.zeros((Np, 3), np.float32)
    x0[:N] = params.t.cpu().numpy()
    dev = params.t.device
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    solve = chain.make_chain_translation_solver(group, Np, cap,
                                                cg_iters=cg_iters)
    t = solve(on(d_chain), on(lc_src), on(lc_dst), on(lc_d), on(lc_w),
              w_chain=on(wc), x0=on(x0))
    return t[:N]


def _dump_round_trajectories(args, world, Y, dump_idx, expand_fn=None):
    """Mid-optimization trajectory dump per robot
    (kimera_distributed_poses_tum_<k>.tum) of the rounded blocks Y."""
    from ..core import lie, stiefel
    from ..io import logs
    from ..solve.pgo import PgoParams

    R_all, t_all = stiefel.round_solution(Y.reshape(-1, *Y.shape[2:]), 3)
    if expand_fn is not None:
        p = expand_fn(PgoParams(R=R_all, t=t_all))
        R_all, t_all = p.R, p.t
    q_all = lie.rot_to_quat(R_all).cpu().numpy()
    t_all = t_all.cpu().numpy()
    T = args.steps
    for r in range(args.robots):
        sl = slice(r * T, (r + 1) * T)
        logs.write_tum(
            os.path.join(args.log_dir, f"robot{r}", "distributed",
                         f"kimera_distributed_poses_tum_{dump_idx}.tum"),
            world.timestamps[r], t_all[sl], q_all[sl])


def write_logs(args, world, fe, params, weights, dpgo_rows, gt_mask=None,
               final_idx=None):
    """The reference-schema log tree and `ape_robot<r>.csv` per robot;
    returns {robot: ApeResult}. A robot whose `gt_mask` entry is False has
    no ground truth: its logs are written, its APE is not. The final
    trajectory is kimera_distributed_poses_tum_<final_idx>.tum (default
    gnc_rounds // dump_every + 1)."""
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
    if final_idx is None:
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

        # APE against the ground truth (evo_real_time.py's role);
        # suppressed without one: an APE against a placeholder
        # identity / zero trajectory would mislead
        if gt_mask is not None and not gt_mask[r]:
            print(f"[run] robot {r}: no ground truth in session; APE "
                  "suppressed", file=sys.stderr)
            continue
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


# write_artifacts' constants (the JAX package's): the TSDF grid, the
# virtual depth camera the landmark clouds are binned into, the
# deformation graph's kNN, its solver and the output capacities
ARTIFACT_GRID = dict(shape=(96, 96, 16), origin=(-12.0, -12.0, -1.0),
                     voxel_size=0.25, trunc=0.6, n_classes=8)
ARTIFACT_CAM = dict(H=96, W=128, fx=60.0, fy=60.0)
ARTIFACT_KF_STRIDE = 2
ARTIFACT_KNN = 3
ARTIFACT_SURFACE_VERTS = 16384
ARTIFACT_TRIANGLES = 32768


def write_artifacts(args, world, params):
    """Metric-semantic mesh and viewer from the optimized run (the
    Kimera-PGMO role): each robot's odometry-frame positions are deformed
    onto the optimized trajectory by a deformation graph (nodes: the
    odometry poses, kNN k = 3; constraints: every max(T // 8, 1)-th node
    at its optimized position; 4 Gauss-Newton x 30 CG steps), every 2nd
    keyframe's landmark cloud is binned into a 96 x 128 depth and label
    image and TSDF-integrated from its optimized rotation and corrected
    position, then the surface (16,384 vertices), the marching-tetrahedra
    mesh (32,768 triangles) and the viewer are written: surface.ply,
    mesh.ply and run.html under --log-dir. Runs on `params`' device.

    Returns dict(grid (TsdfGrid), states (a DeformationState per robot),
    con_residual (each robot's largest constraint residual norm after the
    solve, metres), n_vertices, n_triangles (valid ones written), paths)."""
    import numpy as np
    import torch

    from ..semantics import marching, mesh_io, tsdf
    from ..solve import deformation as dfm

    dev = params.R.device
    T = args.steps
    grid = tsdf.make_grid(device=dev, **ARTIFACT_GRID)
    H, W = ARTIFACT_CAM["H"], ARTIFACT_CAM["W"]
    fx, fy = ARTIFACT_CAM["fx"], ARTIFACT_CAM["fy"]
    cx, cy = W / 2, H / 2
    cfg = dfm.DeformationConfig(gn_iters=4, cg_iters=30)
    t_odo_kf = _odometry_poses(world)[1]
    trajs, states, con_res = {}, [], []
    for r in range(args.robots):
        sl = slice(r * T, (r + 1) * T)
        R_est, t_est = params.R[sl], params.t[sl]
        trajs[r] = t_est
        # nodes = odometry positions, constraints = optimized keyframes
        graph = dfm.build_graph_knn(
            torch.from_numpy(t_odo_kf[r]).to(dev), k=ARTIFACT_KNN)
        con_node = torch.arange(0, T, max(T // 8, 1), dtype=torch.int32,
                                device=dev)
        con_target = t_est[con_node.long()]
        con_valid = torch.ones(con_node.shape[0], dtype=torch.bool,
                               device=dev)
        state = dfm.solve(dfm.identity_state(T, device=dev), graph,
                          con_node, con_target, con_valid, cfg)
        states.append(state)
        res = dfm.residuals(state, graph, con_node, con_target, con_valid,
                            cfg)[3 * graph.edge_src.shape[0]:]
        con_res.append(float(torch.linalg.vector_norm(
            res.reshape(-1, 3), dim=-1).max()) / cfg.w_con)
        t_corr = graph.node_pos + state.t
        # each kept keyframe's landmarks, integrated from the corrected pose
        kfs = [k for k in range(0, T, ARTIFACT_KF_STRIDE)
               if world.obs_valid[r, k].any()]
        lm = torch.from_numpy(np.ascontiguousarray(
            world.landmarks_local[r, kfs], np.float32)).to(dev)
        ok = torch.from_numpy(np.ascontiguousarray(
            world.obs_valid[r, kfs])).to(dev)
        places = [int(world.place_of_kf[r, k]) % 8 for k in kfs]
        for i, k in enumerate(kfs):
            lab = torch.full((lm.shape[1],), places[i], dtype=torch.int32,
                             device=dev)
            depth, lab_img = tsdf.depth_image_from_points(
                lm[i], lab, ok[i], H, W, fx, fy, cx, cy, dilate=2)
            grid = tsdf.integrate(grid, depth, lab_img, R_est[k], t_corr[k],
                                  fx, fy, cx, cy)
    verts, normals, labels, valid = tsdf.extract_surface(
        grid, ARTIFACT_SURFACE_VERTS)
    paths = {n: os.path.join(args.log_dir, n)
             for n in ("surface.ply", "mesh.ply", "run.html")}
    n_v = mesh_io.write_ply_points(paths["surface.ply"], verts, normals,
                                   labels, valid)
    tris, tvalid = marching.marching_tetrahedra(
        grid, max_triangles=ARTIFACT_TRIANGLES)
    n_t = marching.write_ply_triangles(paths["mesh.ply"], tris, tvalid)
    mesh_io.write_html_viewer(paths["run.html"], trajs,
                              points=verts[valid])
    print(f"[run] artifacts: surface.ply ({n_v} vertices), mesh.ply "
          f"({n_t} triangles), run.html in {args.log_dir}", file=sys.stderr)
    return dict(grid=grid, states=states, con_residual=con_res,
                n_vertices=n_v, n_triangles=n_t, paths=paths)


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
