"""Synthetic loop-closure candidates, keyframe stores and multi-robot pose
graphs (numpy on the host).

Candidate pairs as the kernel benchmark of the JAX package makes them:
two views of one random landmark cloud under a random relative pose, ORB
descriptors that agree up to a few flipped bits for ~60% of the features
and are unrelated clutter for the rest. `make_stores_np` lays such pairs
out as per-robot keyframe stores with the candidate index lists a
verifier takes, plus pairs of unrelated frames that it must reject.
`multi_robot_graph` is the JAX package's pose-graph generator (robots on
interleaved circles, noisy odometry, intra- and inter-robot loop closures
of which a share are gross outliers), with the same numpy draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import backend
from ..core.containers import (EDGE_ODOMETRY, EDGE_PRIVATE_LC,
                               EDGE_SHARED_LC, PoseGraphEdges)


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Batched Rodrigues formula on the host: (..., 3) -> (..., 3, 3)."""
    w = np.asarray(w, np.float32)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    safe = np.maximum(theta, 1e-12)
    k = w / safe[..., 0]
    K = np.zeros(w.shape[:-1] + (3, 3), np.float32)
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), K.shape)
    R = eye + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    return np.where(theta < 1e-8, eye, R).astype(np.float32)


def make_candidates_np(n_cand: int, K: int, seed: int = 0):
    """n_cand candidate pairs of K features each. Returns (desc_a, desc_b
    (n, K, 32) uint8; bear_a, bear_b (n, K, 3) f32 unit bearings; P, Pb
    (n, K, 3) f32 landmarks in frame a / b; valid (n, K) bool; R (n, 3, 3),
    t (n, 3): the pose of frame b in frame a, P = R Pb + t)."""
    npr = np.random.default_rng(seed)
    desc_a = npr.integers(0, 256, (n_cand, K, 32), dtype=np.uint8)
    desc_b = desc_a.copy()
    # ~60% true matches with bit noise, 40% clutter
    clutter = npr.uniform(size=(n_cand, K)) < 0.4
    flips = npr.integers(0, 32, (n_cand, K))
    for c in range(n_cand):
        desc_b[c, np.arange(K), flips[c]] ^= 7
        idx = np.nonzero(clutter[c])[0]
        desc_b[c, idx] = npr.integers(0, 256, (len(idx), 32), dtype=np.uint8)
    P = npr.uniform(-4, 4, (n_cand, K, 3)).astype(np.float32)
    P[..., 2] += 8.0
    R = _so3_exp_np(npr.normal(0, 0.4, (n_cand, 3)).astype(np.float32))
    t = npr.uniform(-1, 1, (n_cand, 3)).astype(np.float32)
    Pb = np.einsum("cij,ckj->cki", R.transpose(0, 2, 1), P - t[:, None, :])
    bear_a = P / np.linalg.norm(P, axis=-1, keepdims=True)
    bear_b = Pb / np.linalg.norm(Pb, axis=-1, keepdims=True)
    valid = np.ones((n_cand, K), bool)
    return (desc_a, desc_b, bear_a.astype(np.float32),
            bear_b.astype(np.float32), P, Pb.astype(np.float32), valid, R, t)


class SyntheticStores(NamedTuple):
    desc: np.ndarray      # (R, T, K, 32) uint8 packed ORB descriptors
    obs_valid: np.ndarray  # (R, T, K) bool
    bearings: np.ndarray  # (R, T, 3, K) f32 coordinate-major
    landmarks: np.ndarray  # (R, T, 3, K) f32 coordinate-major
    qr: np.ndarray        # (N,) int32 query robot of every candidate
    qf: np.ndarray        # (N,) int32 query frame
    tr: np.ndarray        # (N,) int32 target robot
    tm: np.ndarray        # (N,) int32 target frame
    is_true: np.ndarray   # (N,) bool — False for pairs of unrelated frames
    R_gt: np.ndarray      # (N, 3, 3) pose of the target frame in the
    t_gt: np.ndarray      # (N, 3)    query frame (identity where not true)


def make_stores_np(n_robots: int, n_frames: int, K: int, seed: int = 0,
                   n_false: int | None = None,
                   invalid_tail: int = 0) -> SyntheticStores:
    """Keyframe stores for `n_robots` x `n_frames` keyframes of K features.

    Flat frame 2i (robot-major order) and frame 2i+1 are the two views of
    candidate pair i of `make_candidates_np`, so the stores hold
    n_robots * n_frames / 2 true candidates (query = the even frame).
    `n_false` further candidates (default: a third as many) pair an even
    frame with the odd frame of ANOTHER pair: their descriptors and
    geometry are unrelated and a verifier must reject them.
    `invalid_tail` > 0 marks the last (i % (invalid_tail + 1)) features of
    frame i as not observed, so validity masks are exercised.
    """
    n = n_robots * n_frames
    assert n % 2 == 0 and n >= 4, "an even number (>= 4) of frames"
    n_true = n // 2
    if n_false is None:
        n_false = n_true // 3
    da, db, ba, bb, pa, pb, valid, R, t = make_candidates_np(n_true, K, seed)

    def interleave(a, b):
        out = np.empty((n,) + a.shape[1:], a.dtype)
        out[0::2], out[1::2] = a, b
        return out.reshape((n_robots, n_frames) + a.shape[1:])

    def soa(x):
        return np.ascontiguousarray(x.transpose(0, 2, 1))

    obs = interleave(valid, valid).reshape(n, K)
    if invalid_tail > 0:
        cut = K - (np.arange(n) % (invalid_tail + 1))
        obs = obs & (np.arange(K)[None, :] < cut[:, None])
    pair = np.arange(n_true)
    other = (pair[:n_false] + 1 + n_true // 2) % n_true  # never the own pair
    q_flat = np.concatenate([2 * pair, 2 * pair[:n_false]])
    t_flat = np.concatenate([2 * pair + 1, 2 * other + 1])
    is_true = np.arange(n_true + n_false) < n_true
    R_gt = np.concatenate([R, np.broadcast_to(np.eye(3, dtype=np.float32),
                                              (n_false, 3, 3))])
    t_gt = np.concatenate([t, np.zeros((n_false, 3), np.float32)])
    return SyntheticStores(
        desc=interleave(da, db),
        obs_valid=obs.reshape(n_robots, n_frames, K),
        bearings=interleave(soa(ba), soa(bb)),
        landmarks=interleave(soa(pa), soa(pb)),
        qr=(q_flat // n_frames).astype(np.int32),
        qf=(q_flat % n_frames).astype(np.int32),
        tr=(t_flat // n_frames).astype(np.int32),
        tm=(t_flat % n_frames).astype(np.int32),
        is_true=is_true, R_gt=R_gt.astype(np.float32), t_gt=t_gt)


class SyntheticGraph(NamedTuple):
    edges: PoseGraphEdges
    R_gt: torch.Tensor  # (n_robots * n_poses, 3, 3)
    t_gt: torch.Tensor  # (n_robots * n_poses, 3)
    is_outlier: torch.Tensor  # (E,) bool ground-truth outlier labels
    n_robots: int
    poses_per_robot: int


def multi_robot_graph_np(
    seed: int = 0,
    n_robots: int = 2,
    n_poses: int = 64,
    edge_capacity: int | None = None,
    rot_noise: float = 0.005,
    trans_noise: float = 0.01,
    n_intra_lc: int = 8,
    n_inter_lc: int = 12,
    outlier_ratio: float = 0.3,
    kappa: float = 1e4,
    tau: float = 1e2,
) -> dict:
    """The graph of `multi_robot_graph` as numpy arrays: the edge fields
    (`src_robot`, ..., `etype`), `R_gt`, `t_gt` and `is_outlier`."""
    npr = np.random.default_rng(seed)
    N = n_robots * n_poses

    # ground truth: concentric circles with phase offsets
    R_gt = np.zeros((n_robots, n_poses, 3, 3), np.float32)
    t_gt = np.zeros((n_robots, n_poses, 3), np.float32)
    for r in range(n_robots):
        radius = 5.0 + 0.3 * r
        phase = 2 * np.pi * r / max(n_robots, 1) * 0.25
        ang = np.linspace(0, 1.5 * np.pi, n_poses) + phase
        t_gt[r, :, 0] = radius * np.cos(ang)
        t_gt[r, :, 1] = radius * np.sin(ang)
        t_gt[r, :, 2] = 0.1 * r
        yaw = ang + np.pi / 2
        w = np.stack([0 * yaw, 0 * yaw, yaw], -1)
        R_gt[r] = _so3_exp_np(w)
    R_gt = R_gt.reshape(N, 3, 3)
    t_gt = t_gt.reshape(N, 3)

    def rel_batch(i, j):
        Ri, ti = R_gt[i], t_gt[i]
        Rj, tj = R_gt[j], t_gt[j]
        Rb = np.einsum("eji,ejk->eik", Ri, Rj)
        tb = np.einsum("eji,ej->ei", Ri, tj - ti)
        return Rb, tb

    def noisy_batch(Rb, tb):
        n = Rb.shape[0]
        dw = npr.normal(0, rot_noise, (n, 3)).astype(np.float32)
        Rn = _so3_exp_np(dw) @ Rb
        tn = tb + npr.normal(0, trans_noise, (n, 3)).astype(np.float32)
        return Rn.astype(np.float32), tn.astype(np.float32)

    rr = np.repeat(np.arange(n_robots), n_poses - 1)
    kk = np.tile(np.arange(n_poses - 1), n_robots)
    io_ = rr * n_poses + kk
    R_odo, t_odo = noisy_batch(*rel_batch(io_, io_ + 1))

    lc_rows = []  # (r1, k1, r2, k2, etype, is_out)

    def add_lc(r1, r2, count, etype):
        made = 0
        trials = 0
        while made < count and trials < count * 50:
            trials += 1
            k1 = int(npr.integers(0, n_poses))
            k2 = int(npr.integers(0, n_poses))
            if r1 == r2 and abs(k1 - k2) < max(5, n_poses // 8):
                continue
            i, j = r1 * n_poses + k1, r2 * n_poses + k2
            if np.linalg.norm(t_gt[i] - t_gt[j]) > 3.0:
                continue
            is_out = bool(npr.uniform() < outlier_ratio)
            lc_rows.append((r1, k1, r2, k2, etype, is_out))
            made += 1

    for r in range(n_robots):
        add_lc(r, r, n_intra_lc, EDGE_PRIVATE_LC)
    for r1 in range(n_robots):
        for r2 in range(r1 + 1, n_robots):
            add_lc(r1, r2, n_inter_lc, EDGE_SHARED_LC)

    n_lc = len(lc_rows)
    if n_lc:
        lr1, lk1, lr2, lk2, let = (
            np.asarray([x[i] for x in lc_rows], np.int32) for i in range(5))
        lout = np.asarray([x[5] for x in lc_rows], bool)
        R_lc, t_lc = noisy_batch(*rel_batch(lr1 * n_poses + lk1,
                                            lr2 * n_poses + lk2))
        n_out = int(lout.sum())
        if n_out:  # gross random transforms
            R_lc[lout] = _so3_exp_np(
                npr.normal(0, 1.5, (n_out, 3)).astype(np.float32))
            t_lc[lout] = npr.uniform(-8, 8, (n_out, 3)).astype(np.float32)
    else:
        lr1 = lk1 = lr2 = lk2 = let = np.zeros(0, np.int32)
        lout = np.zeros(0, bool)
        R_lc = np.zeros((0, 3, 3), np.float32)
        t_lc = np.zeros((0, 3), np.float32)

    E_odo = len(io_)
    E = E_odo + n_lc
    cap = edge_capacity or int(2 ** np.ceil(np.log2(max(E, 8))))
    if cap < E:
        raise ValueError(f"edge_capacity {cap} < generated edges {E}")

    def col(odo_vals, lc_vals, dtype=np.int32):
        out = np.zeros(cap, dtype)
        out[:E_odo] = odo_vals
        out[E_odo:E] = lc_vals
        return out

    Rm = np.broadcast_to(np.eye(3, dtype=np.float32), (cap, 3, 3)).copy()
    tm = np.zeros((cap, 3), np.float32)
    Rm[:E_odo], tm[:E_odo] = R_odo, t_odo
    Rm[E_odo:E], tm[E_odo:E] = R_lc, t_lc
    kap = np.zeros(cap, np.float32)
    ta = np.zeros(cap, np.float32)
    kap[:E] = kappa
    ta[:E] = tau
    out = np.zeros(cap, bool)
    out[E_odo:E] = lout
    return dict(
        src_robot=col(rr, lr1), src_pose=col(kk, lk1),
        dst_robot=col(rr, lr2), dst_pose=col(kk + 1, lk2),
        R=Rm, t=tm, kappa=kap, tau=ta,
        etype=col(np.full(E_odo, EDGE_ODOMETRY, np.int32), let),
        R_gt=R_gt, t_gt=t_gt, is_outlier=out)


def multi_robot_graph(seed: int = 0, n_robots: int = 2, n_poses: int = 64,
                      *args, device="cuda", **kwargs) -> SyntheticGraph:
    """The JAX package's `multi_robot_graph` (same arguments, same numpy
    draws, so the same graph for a seed), as tensors on `device`."""
    from ..convert import edges_from_numpy

    dev = backend.resolve_device(device)
    g = multi_robot_graph_np(seed, n_robots, n_poses, *args, **kwargs)
    return SyntheticGraph(
        edges=edges_from_numpy(**{f: g[f] for f in (
            "src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
            "kappa", "tau", "etype")}, device=dev),
        R_gt=torch.from_numpy(g["R_gt"]).to(dev),
        t_gt=torch.from_numpy(g["t_gt"]).to(dev),
        is_outlier=torch.from_numpy(g["is_outlier"]).to(dev),
        n_robots=n_robots, poses_per_robot=n_poses)
