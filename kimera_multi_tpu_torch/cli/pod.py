"""One DCN pod: a separate PROCESS owning a subset of robots (the JAX
package's cli/pod.py).

Role of one machine in the reference's deployed topology: a robot
workstation running kimera_distributed + dpgo_ros and talking to the
others over the mesh network. Inside a pod the port's front-end and
rounds run on its device (`--device`, the card unless told otherwise);
everything BETWEEN pods crosses a real process boundary over dist/dcn.py
(the native TCP wire format, the JAX package's byte for byte).

Protocol per run (bulk-synchronous rounds; the front-end data cross the
wire as in the deployment's traffic pattern):

  vocab round      rank 0 builds the vocabulary from its own sensing and
                   broadcasts it (stand-in for the shared mit_voc.yml
                   every robot loads at launch)
  stream rounds    per round each pod publishes AT MOST bow_batch BoW
                   vectors of keyframes produced so far, skipping every
                   bow_skip-th (bow_batch_size / bow_skip_num); per-round
                   byte counts are bounded and logged
  gap-fill         pods request the BoW vectors still missing
                   (request_bow_vectors); a late-joining robot
                   (--late-robot) is recovered entirely here
  detect           fleet-wide BoW scoring on the streamed database
  vlc on demand    only the VLC frames that verification candidates
                   reference cross the wire (vlc_frame_request), then
                   each pod verifies its own robots' queries

  edge exchange    each pod broadcasts its odometry + committed loop
                   edges (request_pose_graph / loop-closure traffic)
  dpgo rounds      dist/rounds.py's `make_round_fn` rounds over the
                   pods as a robot group (dist/dcn.py's `FabricGroup`,
                   pod k owning every robot r with r % P == k): the owned
                   robots' block-Newton directions, DCN all-gathers of
                   the blocks, flags and directions, the replicated
                   global step and periodic GNC reweighting (dpgo_ros's
                   UPDATE rounds with pose traffic over the wire)
  hash barrier     pods exchange a digest of the rounded, polished
                   solution and the GNC weights and require bit-identical
                   consensus, then write their own robots' TUM logs + APE.

Every pod prints one JSON line last (agree, digest, APE of its robots and
of their odometry, bytes a dpgo round, the CUDA kernels it launched, ...)
and writes
LOG/pod<rank>_solution.npz (the merged graph's edges, the final lifted
blocks Y, R, t, weights). It exits 1 when the barrier fails.

Launch (2 pods x 2 robots):
  python -m kimera_multi_tpu_torch.cli.pod --rank 0 --pods 2 --robots 4 \\
      --port-base P [--device cpu] ... &
  python -m kimera_multi_tpu_torch.cli.pod --rank 1 --pods 2 --robots 4 \\
      --port-base P [--device cpu] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import zlib


def log(rank, msg):
    print(f"[pod {rank}] {msg}", file=sys.stderr, flush=True)


# the dpgo rounds' schedule (the JAX package's pod): one (direction ->
# global step) cycle a round, GNC reweighting every 2nd round from round 8
POD_INNER_ITERS, POD_GNC_EVERY, POD_BURNIN = 1, 2, 8


def digest_of(params, weights) -> int:
    """CRC-32 of the rounded, polished solution and the GNC weights
    (float32 bytes): rotations, translations AND weights, so pods that
    agree on translations alone do not pass."""
    import numpy as np

    f32 = lambda t: t.cpu().numpy().astype(np.float32).tobytes()
    return zlib.crc32(f32(params.R) + f32(params.t) + f32(weights))


def main(argv=None):
    p = argparse.ArgumentParser(description="kimera_multi_tpu_torch DCN pod")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--pods", type=int, required=True)
    p.add_argument("--robots", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--port-base", type=int, default=47600)
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--log-dir", default="kmt_torch_pod_logs")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--bow-chunk", type=int, default=4,
                   help="keyframe steps 'produced' per stream round")
    p.add_argument("--bow-batch", type=int, default=16,
                   help="bow_batch_size: max BoW vectors published per "
                        "stream round")
    p.add_argument("--bow-skip", type=int, default=0,
                   help="bow_skip_num: publish every (skip+1)-th BoW; "
                        "the rest only on request")
    p.add_argument("--late-robot", type=int, default=-1,
                   help="simulate this robot joining late: its BoWs are "
                        "never streamed, only gap-filled")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..core import backend, lie, stiefel
    from ..core.containers import EDGE_ODOMETRY, concat_edges
    from ..dist import dcn
    from ..eval import ape as ape_mod
    from ..frontend import batched, dlc, vocab as vocab_mod
    from ..io import logs, sim_world
    from ..dist import rounds
    from ..solve import pgo, rbcd

    dev = backend.resolve_device(args.device)
    t_start = time.time()
    rank, pods = args.rank, args.pods
    own = dcn.owned_robots(rank, pods, args.robots)
    log(rank, f"owns robots {own} of {args.robots} on {dev}; connecting "
              f"fabric on ports {args.port_base}+")
    fabric = dcn.DcnFabric(rank, pods, args.port_base)

    # each pod SENSES only its own robots; the rest of the fleet's
    # keyframes arrive over the wire
    world = sim_world.make_world(
        n_robots=args.robots, n_steps=args.steps,
        features_per_kf=args.features, seed=args.seed)
    R, T, K = args.robots, args.steps, args.features
    desc = np.zeros((R, T, K, 32), np.uint8)
    bear = np.zeros((R, T, K, 3), np.float32)
    lm = np.zeros((R, T, K, 3), np.float32)
    ovalid = np.zeros((R, T, K), bool)
    for r in own:
        desc[r] = world.descriptors[r]
        bear[r] = world.bearings_local[r]
        lm[r] = world.landmarks_local[r]
        ovalid[r] = world.obs_valid[r]

    cfg = dlc.FrontendConfig(base_seed=args.seed)
    own_set = set(own)
    rnd = 0

    def own_vocabulary():
        corpus = desc[ovalid].reshape(-1, 32)
        sub = corpus[:: max(1, len(corpus) // 4000)]
        return vocab_mod.build_vocabulary(sub, k=8, depth=3, seed=args.seed,
                                          device=dev)

    # ---- vocab round: rank 0 builds from its own sensing, broadcasts --
    if rank == 0:
        voc = own_vocabulary()
        for i, c in enumerate(voc.centroids):
            fabric.send_tensor(900 + i, c.cpu().numpy())
        for i, nv in enumerate(voc.node_valid):
            fabric.send_tensor(920 + i, nv.cpu().numpy().astype(np.uint8))
        fabric.send_tensor(940, voc.word_weights.cpu().numpy().astype(
            np.float32))
        fabric.send_ctrl(dcn.CTRL_HASH, rnd,
                         value=voc.k * 1000 + voc.depth)
    fabric.end_batch(rnd)
    got = fabric.collect(rnd)
    rnd += 1
    if rank != 0:
        kd = [c.value for c in got["ctrl"]
              if c.kind == dcn.CTRL_HASH and c.sender == 0][0]
        k_v, depth_v = kd // 1000, kd % 1000
        tens = {t.tag: t.array for t in got["tensors"] if t.sender == 0}
        on = lambda a, dt: torch.from_numpy(a).to(dev, dt)  # noqa: E731
        voc = vocab_mod.Vocabulary(
            k=k_v, depth=depth_v,
            centroids=tuple(on(tens[900 + i], torch.uint8)
                            for i in range(depth_v)),
            word_weights=on(tens[940], torch.float32),
            node_valid=tuple(on(tens[920 + i], torch.bool)
                             for i in range(depth_v)))
    log(rank, "vocabulary shared (rank-0 broadcast)")

    fe = batched.BatchedFrontend(R, T, voc, cfg, device=dev)
    ids, wts, _qi, _qw, _ovf = fe.compute_bows(desc, ovalid)
    kfv = ovalid.any(-1)
    withhold = ((lambda r: r == args.late_robot)
                if args.late_robot >= 0 else None)
    ids, wts, have, bow_round_bytes, rnd = dcn.stream_bow_exchange(
        fabric, own, kfv, ids, wts, rnd, chunk=args.bow_chunk,
        batch_size=args.bow_batch, skip=args.bow_skip, withhold=withhold,
        log=lambda m: log(rank, m))
    rr, kk, tt, mm = fe.detect_candidates(
        bows=(ids, wts), kf_valid=have, query_robots=own)
    # on-demand VLC: only candidate target frames not owned locally
    pairs = sorted({(int(t), int(f)) for t, f in zip(tt, mm)
                    if int(t) not in own_set})
    rnd = dcn.vlc_request_exchange(
        fabric, own, np.asarray(pairs, np.int32).reshape(-1, 2),
        desc, bear, lm, ovalid, rnd, log=lambda m: log(rank, m))
    stats = fe.verify_candidates(desc, bear, lm, ovalid)
    log(rank, f"front-end: {stats['n_candidates']} own-query candidates, "
              f"{len(fe.loops)} committed loops")

    # ---- edge exchange ------------------------------------------------
    local = dlc.build_pose_graph_from_loops(
        fe.loops, world.R_odo[own], world.t_odo[own], cfg, device="cpu")
    # build_pose_graph_from_loops numbers odometry rows 0..len(own)-1;
    # map them back to fleet robot ids before they go on the wire
    own_t = torch.tensor(own, dtype=torch.int32)
    is_odo = local.etype == EDGE_ODOMETRY
    fleet_id = lambda r: torch.where(  # noqa: E731
        is_odo, own_t[torch.where(is_odo, r, 0).long()], r)
    local = dataclasses.replace(local, src_robot=fleet_id(local.src_robot),
                                dst_robot=fleet_id(local.dst_robot))
    fabric.send_edges(local)
    fabric.end_batch(rnd)
    got = fabric.collect(rnd, max_edges=local.capacity * pods * 2)
    rnd += 1
    # deterministic merge: edge batches in sender-rank order (the fabric
    # attributes each batch to its sender at the transport layer)
    by_pod: dict[int, list] = {i: [] for i in range(pods)}
    by_pod[rank].append(local)
    for sender, b in got["edges"]:
        by_pod[sender].append(b)
    edges = concat_edges([b for i in sorted(by_pod) for b in by_pod[i]],
                         device=dev)
    log(rank, f"edge exchange done: {int(edges.valid.sum())} edges in the "
              "shared graph")

    # ---- distributed PGO over DCN ---------------------------------------
    ppr = T
    sent0, recv0 = fabric.bytes_counters()
    group = dcn.FabricGroup(fabric, R, dev, rnd)
    round_fn = rounds.make_round_fn(
        group, edges, ppr, rbcd.RbcdConfig(inner_iters=POD_INNER_ITERS),
        weight_update_every=POD_GNC_EVERY, burnin_rounds=POD_BURNIN)
    state = initial_state(edges, R, ppr, args.seed)
    cost = float("nan")
    t_rounds = backend.synced_clock(dev)
    for _ in range(args.rounds):
        state, cost = round_fn(state)
    cost = float(cost)
    rnd = group.rnd
    rounds_s = backend.synced_clock(dev) - t_rounds
    sent1, recv1 = fabric.bytes_counters()
    bytes_per_round = (recv1 - recv0) / max(args.rounds, 1)
    log(rank, f"dpgo: {args.rounds} rounds in {rounds_s:.2f} s, final cost "
              f"{cost:.4f}, DCN traffic {(recv1 - recv0) / 1e6:.2f} MB in / "
              f"{(sent1 - sent0) / 1e6:.2f} MB out, {bytes_per_round:.0f} B "
              "received a round")

    # ---- round + consensus check + logs ---------------------------------
    Y, weights = state.Y, state.gnc_state.weights
    R_all, t_all = stiefel.round_solution(Y.reshape(-1, *Y.shape[2:]), 3)
    Rg, tg = lie.se3_inverse(R_all[0], t_all[0])
    n_all = R_all.shape[0]
    R_all, t_all = lie.se3_compose(Rg.expand(n_all, 3, 3),
                                   tg.expand(n_all, 3), R_all, t_all)
    params = pgo.gauss_newton(pgo.PgoParams(R=R_all, t=t_all), edges,
                              weights, ppr, gn_iters=5, cg_iters=40)
    digest = digest_of(params, weights)
    wire_digest = digest - (1 << 32) if digest >= (1 << 31) else digest
    fabric.send_ctrl(dcn.CTRL_HASH, rnd, value=wire_digest)
    fabric.end_batch(rnd)
    got = fabric.collect(rnd)
    peer_digests = {c.sender: c.value for c in got["ctrl"]
                    if c.kind == dcn.CTRL_HASH}
    agree = (len(peer_digests) == pods - 1
             and all(v == wire_digest for v in peer_digests.values()))
    log(rank, f"consensus: digest {digest:#010x}, {len(peer_digests)} peers, "
              f"agree={agree}")

    # per-owned-robot logs + APE (each pod writes only its robots, like
    # each reference machine logging its own namespace)
    os.makedirs(args.log_dir, exist_ok=True)
    params_odo = pgo.init_from_odometry(edges, R, ppr)
    q_all = lie.rot_to_quat(params.R).cpu().numpy()
    t_np = params.t.cpu().numpy()
    ape_vals, ape_odo = {}, {}
    for r in own:
        sl = slice(r * ppr, r * ppr + T)
        logs.write_tum(
            os.path.join(args.log_dir, f"robot{r}", "distributed",
                         f"kimera_distributed_poses_tum_{r}.tum"),
            world.timestamps[r], t_np[sl], q_all[sl])
        gt_t = torch.from_numpy(world.t_gt[r]).to(dev)
        gt_R = torch.from_numpy(world.R_gt[r]).to(dev)
        ape_vals[r] = float(ape_mod.ape(params.t[sl], params.R[sl], gt_t,
                                        gt_R).rmse_trans)
        ape_odo[r] = float(ape_mod.ape(params_odo.t[sl], params_odo.R[sl],
                                       gt_t, gt_R).rmse_trans)
        log(rank, f"robot {r}: APE trans RMSE = {ape_vals[r]:.4f} m "
                  f"(odometry {ape_odo[r]:.4f})")
    np_of = lambda x: x.cpu().numpy()  # noqa: E731
    np.savez(os.path.join(args.log_dir, f"pod{rank}_solution.npz"),
             Y=np_of(Y), R=np_of(params.R), t=np_of(params.t),
             weights=np_of(weights),
             **{f"edges_{f.name}": np_of(getattr(edges, f.name))
                for f in dataclasses.fields(edges)})

    from ..kernels import _build

    sent, recv = fabric.bytes_counters()
    print(json.dumps({
        "pod": rank, "pods": pods, "robots": own, "device": str(dev),
        "agree": bool(agree), "digest": int(digest),
        "final_cost": cost, "ape_rmse": ape_vals, "ape_odometry": ape_odo,
        "n_loops": len(fe.loops),
        "n_edges": int(edges.valid.sum()),
        "bow_round_bytes": bow_round_bytes, "rounds": args.rounds,
        "dpgo_bytes_per_round": bytes_per_round, "rounds_s": rounds_s,
        "dcn_bytes_sent": int(sent), "dcn_bytes_received": int(recv),
        "kernel_launches": dict(_build.launches),
        "wall_s": time.time() - t_start}), flush=True)
    fabric.close()
    return 0 if agree else 1


def initial_state(edges, n_robots: int, ppr: int, seed: int):
    """The dpgo rounds' start, the sharded back-end's (cli/run.py):
    odometry initialization and `rounds.lifted_start`, GNC seeded at the
    lifted blocks with the consensus weights. Returns the RoundState."""
    import torch

    from ..dist import rounds
    from ..solve import pgo

    params0 = pgo.init_from_odometry(edges, n_robots, ppr)
    Y0, w0, _c, _ok = rounds.lifted_start(params0, edges, n_robots, ppr,
                                          seed)
    return rounds.init_state(Y0, torch.ones(n_robots, dtype=torch.bool,
                                            device=Y0.device),
                             edges, ppr, init_weights=w0)


if __name__ == "__main__":
    sys.exit(main())
