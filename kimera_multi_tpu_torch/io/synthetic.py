"""Synthetic loop-closure candidates and keyframe stores (numpy, host).

Candidate pairs as the kernel benchmark of the JAX package makes them:
two views of one random landmark cloud under a random relative pose, ORB
descriptors that agree up to a few flipped bits for ~60% of the features
and are unrelated clutter for the rest. `make_stores_np` lays such pairs
out as per-robot keyframe stores with the candidate index lists a
verifier takes, plus pairs of unrelated frames that it must reject.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
