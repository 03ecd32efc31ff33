"""The flagship step as one call: a fused multi-robot SLAM step.

`entry()` returns (slam_step, example_args), the JAX package's
`__graft_entry__.entry` on the card: loop-closure candidate verification
(pair Hamming 2-NN + Lowe, the 8-point mono RANSAC gate and 3d-3d
RANSAC pose recovery) feeding one parallel lifted-RBCD round on a
2-robot pose graph. The verification goes through the hand-written
kernels: the pair top-2 (K1), the permuted sample gathers (K4, twice in
each gate), the essential counts (K9) and the rigid counts (K8).
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
