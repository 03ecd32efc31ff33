"""Synthetic multi-robot sensor world: keyframes with descriptors and
landmarks over revisitable places (numpy, host).

The stand-in for a recorded run: robots traverse overlapping circuits
through a ring of places; a keyframe near a place observes that place's
ORB-like descriptor set and 3D landmarks with noise, so genuine loop
closures exist wherever trajectories revisit or cross — detectable and
verifiable by the real front-end. The numpy generator is called in the
JAX package's order, so descriptors, validity and places come out equal to
its world for the same seed and the floats equal within rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .synthetic import _so3_exp_np


class SimWorld(NamedTuple):
    # ground truth
    R_gt: np.ndarray  # (R, T, 3, 3)
    t_gt: np.ndarray  # (R, T, 3)
    timestamps: np.ndarray  # (R, T) seconds
    # odometry measurements (noisy relative poses, step k -> k+1)
    R_odo: np.ndarray  # (R, T-1, 3, 3)
    t_odo: np.ndarray  # (R, T-1, 3)
    # observations per keyframe
    descriptors: np.ndarray  # (R, T, K, 32) uint8
    landmarks_local: np.ndarray  # (R, T, K, 3) float32 (camera frame)
    bearings_local: np.ndarray  # (R, T, K, 3) float32
    obs_valid: np.ndarray  # (R, T, K) bool
    place_of_kf: np.ndarray  # (R, T) int32 — ground-truth place labels
    n_robots: int
    n_steps: int


def make_world(
    n_robots: int = 2,
    n_steps: int = 60,
    features_per_kf: int = 96,
    n_places: int = 24,
    seed: int = 0,
    rot_noise: float = 0.002,
    trans_noise: float = 0.01,
    descriptor_flip_bits: int = 6,
    landmark_noise: float = 0.01,
    dt: float = 0.5,
) -> SimWorld:
    npr = np.random.default_rng(seed)

    # places on a ring; each has a descriptor bank + 3D landmark cloud
    place_angle = np.linspace(0, 2 * np.pi, n_places, endpoint=False)
    place_pos = np.stack(
        [8.0 * np.cos(place_angle), 8.0 * np.sin(place_angle),
         np.zeros(n_places)], -1
    ).astype(np.float32)
    place_desc = npr.integers(0, 256, (n_places, features_per_kf, 32),
                              dtype=np.uint8)
    place_pts = (place_pos[:, None, :] + npr.uniform(
        -2, 2, (n_places, features_per_kf, 3)).astype(np.float32))

    R_gt = np.zeros((n_robots, n_steps, 3, 3), np.float32)
    t_gt = np.zeros((n_robots, n_steps, 3), np.float32)
    for r in range(n_robots):
        # robots loop the ring at different phases; 1.5 laps so every
        # robot revisits places and crosses the others' paths
        phase = 2 * np.pi * r / n_robots
        ang = phase + np.linspace(0, 3 * np.pi, n_steps)
        t_gt[r, :, 0] = 8.0 * np.cos(ang)
        t_gt[r, :, 1] = 8.0 * np.sin(ang)
        t_gt[r, :, 2] = 0.0
        yaw = ang + np.pi / 2
        w = np.stack([0 * yaw, 0 * yaw, yaw], -1)
        R_gt[r] = _so3_exp_np(w.astype(np.float32))

    timestamps = (np.arange(n_steps) * dt)[None, :].repeat(n_robots, 0)

    # odometry: noisy relative poses
    R_odo = np.zeros((n_robots, n_steps - 1, 3, 3), np.float32)
    t_odo = np.zeros((n_robots, n_steps - 1, 3), np.float32)
    for r in range(n_robots):
        Ra, ta = R_gt[r, :-1], t_gt[r, :-1]
        Rb, tb = R_gt[r, 1:], t_gt[r, 1:]
        Rrel = np.einsum("kji,kjl->kil", Ra, Rb)
        trel = np.einsum("kji,kj->ki", Ra, tb - ta)
        dw = npr.normal(0, rot_noise, (n_steps - 1, 3)).astype(np.float32)
        Rn = _so3_exp_np(dw)
        R_odo[r] = np.einsum("kij,kjl->kil", Rn, Rrel)
        t_odo[r] = trel + npr.normal(0, trans_noise,
                                     (n_steps - 1, 3)).astype(np.float32)

    # observations: nearest place within range
    K = features_per_kf
    descriptors = np.zeros((n_robots, n_steps, K, 32), np.uint8)
    landmarks = np.zeros((n_robots, n_steps, K, 3), np.float32)
    bearings = np.zeros((n_robots, n_steps, K, 3), np.float32)
    valid = np.zeros((n_robots, n_steps, K), bool)
    place_of = np.full((n_robots, n_steps), -1, np.int32)
    for r in range(n_robots):
        for k in range(n_steps):
            d = np.linalg.norm(place_pos - t_gt[r, k], axis=1)
            p = int(np.argmin(d))
            if d[p] > 4.0:
                continue
            place_of[r, k] = p
            desc = place_desc[p].copy()
            # per-observation bit noise
            for _ in range(descriptor_flip_bits):
                rows = npr.integers(0, K, K)
                cols = npr.integers(0, 32, K)
                desc[rows, cols] ^= np.uint8(1 << int(npr.integers(0, 8)))
            descriptors[r, k] = desc
            # landmarks in the camera frame
            pts_w = place_pts[p] + npr.normal(
                0, landmark_noise, (K, 3)).astype(np.float32)
            pts_c = np.einsum("ji,kj->ki", R_gt[r, k], pts_w - t_gt[r, k])
            landmarks[r, k] = pts_c
            norms = np.linalg.norm(pts_c, axis=1, keepdims=True)
            bearings[r, k] = pts_c / np.maximum(norms, 1e-9)
            valid[r, k] = True

    return SimWorld(
        R_gt=R_gt, t_gt=t_gt, timestamps=timestamps, R_odo=R_odo,
        t_odo=t_odo, descriptors=descriptors, landmarks_local=landmarks,
        bearings_local=bearings, obs_valid=valid, place_of_kf=place_of,
        n_robots=n_robots, n_steps=n_steps)
