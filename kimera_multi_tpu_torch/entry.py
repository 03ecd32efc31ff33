"""The flagship step as one call: a fused multi-robot SLAM step, and the
distributed dry run.

`entry()` returns (slam_step, example_args), the JAX package's
`__graft_entry__.entry` on the card: loop-closure candidate verification
(pair Hamming 2-NN + Lowe, the 8-point mono RANSAC gate and 3d-3d
RANSAC pose recovery) feeding one parallel lifted-RBCD round on a
2-robot pose graph. The verification goes through the hand-written
kernels: the pair top-2 (K1), the permuted sample gathers (K4, twice in
each gate), the essential counts (K9) and the rigid counts (K8).

`dryrun_multichip(n)` runs the four distributed stages of the JAX
package's `__graft_entry__.dryrun_multichip` over a robot group of n ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import backend, rng, stiefel
from .io.synthetic import multi_robot_graph
from .kernels import hamming, ransac
from .solve import pgo, rbcd


def _make_verify_inputs(n_candidates=4, K=64, seed=0, device="cuda"):
    """Candidate pairs of the JAX package's entry step (same numpy draws):
    descriptors that differ by a few flipped bits, landmarks and their
    bearings in SoA (C, 3, K) layout, all features valid."""
    npr = np.random.default_rng(seed)
    desc_a = npr.integers(0, 256, (n_candidates, K, 32), dtype=np.uint8)
    desc_b = desc_a.copy()
    flip = npr.integers(0, 32, (n_candidates, K))
    for c in range(n_candidates):
        desc_b[c, np.arange(K), flip[c]] ^= 5
    P = npr.uniform(-3, 3, (n_candidates, K, 3)).astype(np.float32)
    P[..., 2] += 6.0
    lm_a = P
    lm_b = P + npr.normal(0, 0.01, P.shape).astype(np.float32)
    bear_a = P / np.linalg.norm(P, axis=-1, keepdims=True)
    bear_b = lm_b / np.linalg.norm(lm_b, axis=-1, keepdims=True)
    valid = np.ones((n_candidates, K), bool)
    soa = lambda a: np.ascontiguousarray(
        a.astype(np.float32).transpose(0, 2, 1))
    return tuple(torch.from_numpy(a).to(device) for a in (
        desc_a, desc_b, soa(bear_a), soa(bear_b), soa(lm_a), soa(lm_b),
        valid))


def entry(device=None):
    """(slam_step, example_args) on `device` (default: the card; asking
    for the card where there is none raises)."""
    dev = (backend.default_device() if device is None
           else backend.resolve_device(device))
    g = multi_robot_graph(seed=0, n_robots=2, n_poses=16, outlier_ratio=0.2,
                          n_intra_lc=3, n_inter_lc=4, device=dev)
    params0 = pgo.init_from_odometry(g.edges, g.n_robots, g.poses_per_robot)
    key = rng.derive(rng.base_key(0, device=dev), rng.Stream.LIFTING)
    ylift = stiefel.random_lifting_matrix(key, 5, 3)
    Y0 = rbcd.lift_params(params0, ylift, g.n_robots, g.poses_per_robot)
    cfg = rbcd.RbcdConfig(inner_iters=1, cg_iters=8)
    edges = g.edges
    ppr = g.poses_per_robot
    active = torch.ones(g.n_robots, dtype=torch.bool, device=dev)
    ones = torch.ones(edges.capacity, device=dev)
    # the round's edge buckets and incidence table, built on the host here
    # so that the step itself reads nothing back; the bucketed round is
    # the JAX step's masked round over all edges, bit for bit on the CPU
    buckets = rbcd.bucket_edges(edges, g.n_robots, ppr)
    base = rng.base_key(7, device=dev)
    kmono = rng.derive(base, rng.Stream.RANSAC_MONO)
    kst = rng.derive(base, rng.Stream.RANSAC_STEREO)

    def slam_step(Y, desc_a, desc_b, bear_a, bear_b, lm_a, lm_b, valid):
        # 1. verification: match, mono gate, 3d-3d pose recovery; every
        # candidate draws its hypotheses from the same key, as the JAX
        # step's vmap does
        C, K = valid.shape
        m, _ = hamming.knn2_lowe_match_pairs(desc_a, valid, desc_b, valid)
        matched = m >= 0
        idx = torch.clamp(m, min=0).long()[:, None, :].expand(C, 3, K)
        fb_m = torch.gather(bear_b, 2, idx)
        pb_m = torch.gather(lm_b, 2, idx)
        mono = ransac.ransac_essential(kmono.expand(C, 2), bear_a, fb_m,
                                       matched, n_hyp=64)
        st = ransac.ransac_arun(kst.expand(C, 2), lm_a, pb_m, matched,
                                n_hyp=64)
        ok = mono["ok"] & st["ok"]
        # 2. back-end: one parallel lifted-RBCD round on the pose graph
        Y_new = rbcd.rbcd_round_reference(Y, active, edges, ones, cfg, ppr,
                                           buckets)
        cost = rbcd.lifted_cost(Y_new.reshape(-1, *Y_new.shape[2:]), edges,
                                ones, ppr)
        return {
            "Y": Y_new,
            "cost": cost,
            "lc_R": st["R"],
            "lc_t": st["t"],
            "lc_ok": ok,
            "mono_inliers": mono["n_inliers"],
            "stereo_inliers": st["n_inliers"],
        }

    example_args = (Y0,) + _make_verify_inputs(device=dev)
    return slam_step, example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One FULL distributed round over a robot group of `n_devices` ranks
    (the JAX package's `__graft_entry__.dryrun_multichip`): with 1, a
    one-rank group made here (dist/mesh.py); with more, the default
    process group, which must have that many ranks (torchrun, or spawned
    processes). Certifies the four distributed stages:

      1. the batched front-end's DETECT (BoW vectors, detection loop);
      2. hypothesis-split 3d-3d RANSAC verification (dist/sharded_verify,
         64 hypotheses a rank; K4 and K8 on the card);
      3. one bucketed lifted-RBCD round with one robot a rank (all_gather
         separator exchange, replicated global step, GNC);
      4. one chain-sharded translation solve (dist/chain, 4 poses a
         rank).

    Prints one line per stage and returns their results."""
    from .dist import chain as chain_mod, mesh, rounds, sharded_verify
    from .frontend import batched as batched_mod, vocab
    from .frontend.dlc import FrontendConfig
    from .io import sim_world

    dev = (backend.default_device() if device is None
           else backend.resolve_device(device))
    out = {}
    # ---- stage 1: batched detect -----------------------------------------
    R_fleet, T, K = min(n_devices, 4), 8, 32
    world = sim_world.make_world(n_robots=R_fleet, n_steps=T,
                                 features_per_kf=K, n_places=6, seed=2)
    voc = vocab.build_vocabulary(world.descriptors.reshape(-1, 32)[:256],
                                 k=4, depth=2, device=dev)
    fe = batched_mod.BatchedFrontend(R_fleet, T, voc,
                                     FrontendConfig(bow_capacity=32),
                                     device=dev)
    rr, _kk, _tt, _mm = fe.detect_candidates(world.descriptors,
                                             world.obs_valid)
    out["n_detected"] = len(rr)
    print(f"dryrun[1/4] batched detect: {len(rr)} candidates ({R_fleet} "
          f"robots x {T} keyframes)")

    with mesh.robot_group(n_devices, dev) as group:
        if group.world != n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the process "
                               f"group has {group.world} ranks")
        # ---- stage 2: hypothesis-split verification -----------------------
        n_hyp = 64 * n_devices
        npr = np.random.default_rng(3)
        P = npr.uniform(-2, 2, (K, 3)).astype(np.float32)
        Q = P + npr.normal(0, 0.01, (K, 3)).astype(np.float32)
        soa = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
            a.T[None])).to(dev)
        res = sharded_verify.make_sharded_arun(group, n_hyp=n_hyp)(
            rng.base_key(5, device=dev)[None], soa(P), soa(Q),
            torch.ones((1, K), dtype=torch.bool, device=dev))
        out.update(n_inliers=int(res["n_inliers"][0]), ok=bool(res["ok"][0]))
        print(f"dryrun[2/4] sharded verify: {n_hyp} hypotheses over "
              f"{n_devices} ranks -> {out['n_inliers']} inliers, "
              f"ok={out['ok']}")

        # ---- stage 3: one robot-sharded bucketed RBCD round ---------------
        g = multi_robot_graph(seed=1, n_robots=n_devices, n_poses=8,
                              outlier_ratio=0.2, n_intra_lc=2, n_inter_lc=3,
                              device=dev)
        params0 = pgo.init_from_odometry(g.edges, g.n_robots,
                                         g.poses_per_robot)
        ylift = stiefel.random_lifting_matrix(
            rng.derive(rng.base_key(0, device=dev), rng.Stream.LIFTING),
            5, 3)
        Y0 = rbcd.lift_params(params0, ylift, g.n_robots, g.poses_per_robot)
        round_fn = rounds.make_round_fn(
            group, g.edges, g.poses_per_robot,
            rbcd.RbcdConfig(inner_iters=1, cg_iters=5),
            weight_update_every=1)
        state = rounds.init_state(
            Y0, torch.ones(n_devices, dtype=torch.bool, device=dev),
            g.edges, g.poses_per_robot)
        state, cost = round_fn(state)
        out["round_cost"] = float(cost)
        print(f"dryrun[3/4] rbcd round ({n_devices} robot ranks): cost = "
              f"{out['round_cost']:.3f}")

        # ---- stage 4: chain-sharded translation solve ---------------------
        n_poses = 4 * n_devices
        solve = chain_mod.make_chain_translation_solver(
            group, n_poses=n_poses, lc_capacity=4, cg_iters=20)
        on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        t_sol = solve(
            on(npr.normal(0, 0.1, (n_poses, 3)).astype(np.float32)),
            on(np.asarray([0, n_poses // 2, -1, -1], np.int32)),
            on(np.asarray([n_poses - 1, n_poses - 2, 0, 0], np.int32)),
            on(npr.normal(0, 0.1, (4, 3)).astype(np.float32)),
            on(np.ones(4, np.float32)))
        out["chain_t_max"] = float(t_sol.abs().max())
        print(f"dryrun[4/4] chain solve: {n_poses} poses over {n_devices} "
              f"ranks, |t|_max = {out['chain_t_max']:.3f}")
    print(f"dryrun_multichip({n_devices}): all 4 stages OK (round cost = "
          f"{out['round_cost']:.3f})")
    return out
