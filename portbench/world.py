"""The synthetic multi-robot keyframe world: a frozen copy of the port's
`io/sim_world.make_world` (and `io/synthetic._so3_exp_np`), numpy on the
host. Robots circle a ring of places; a keyframe near a place observes
that place's descriptor bank and 3D landmarks with noise, so keyframes of
one place match and keyframes of different places do not.

One departure from the copy: `slots` descriptor slots a keyframe, of which
the first `features` are observed (ORB's 700 features padded to 704 slots,
the pair kernel's tile); the rest are marked unobserved.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Batched Rodrigues formula: (..., 3) -> (..., 3, 3), float32."""
    w = np.asarray(w, np.float32)
    theta = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    safe = np.maximum(theta, 1e-12)
    k = w / safe[..., 0]
    K = np.zeros(w.shape[:-1] + (3, 3), np.float32)
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), K.shape)
    R = eye + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    return np.where(theta < 1e-8, eye, R).astype(np.float32)


class World(NamedTuple):
    R_gt: np.ndarray          # (R, T, 3, 3) keyframe poses
    t_gt: np.ndarray          # (R, T, 3)
    descriptors: np.ndarray   # (R, T, K, 32) uint8
    landmarks: np.ndarray     # (R, T, K, 3) float32, camera frame
    bearings: np.ndarray      # (R, T, K, 3) float32, unit
    obs_valid: np.ndarray     # (R, T, K) bool
    place_of_kf: np.ndarray   # (R, T) int32, -1 where no place is in range


def make_world(n_robots: int, n_steps: int, slots: int, features: int,
               n_places: int, seed: int, rot_noise: float = 0.002,
               trans_noise: float = 0.01, descriptor_flip_bits: int = 6,
               landmark_noise: float = 0.01) -> World:
    """The world of `seed`. The generator is called in the port's order
    (odometry draws included, though no output keeps them), so for
    slots == features the arrays equal `make_world(n_robots, n_steps,
    slots, n_places, seed)` of the port."""
    if not 0 < features <= slots:
        raise ValueError("need 0 < features <= slots")
    npr = np.random.default_rng(seed)
    K = slots
    place_angle = np.linspace(0, 2 * np.pi, n_places, endpoint=False)
    place_pos = np.stack(
        [8.0 * np.cos(place_angle), 8.0 * np.sin(place_angle),
         np.zeros(n_places)], -1).astype(np.float32)
    place_desc = npr.integers(0, 256, (n_places, K, 32), dtype=np.uint8)
    place_pts = (place_pos[:, None, :] + npr.uniform(
        -2, 2, (n_places, K, 3)).astype(np.float32))

    R_gt = np.zeros((n_robots, n_steps, 3, 3), np.float32)
    t_gt = np.zeros((n_robots, n_steps, 3), np.float32)
    for r in range(n_robots):
        phase = 2 * np.pi * r / n_robots
        ang = phase + np.linspace(0, 3 * np.pi, n_steps)
        t_gt[r, :, 0] = 8.0 * np.cos(ang)
        t_gt[r, :, 1] = 8.0 * np.sin(ang)
        yaw = ang + np.pi / 2
        w = np.stack([0 * yaw, 0 * yaw, yaw], -1)
        R_gt[r] = so3_exp(w.astype(np.float32))

    # odometry draws: kept so that the stream of draws is the port's
    for r in range(n_robots):
        npr.normal(0, rot_noise, (n_steps - 1, 3))
        npr.normal(0, trans_noise, (n_steps - 1, 3))

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
            for _ in range(descriptor_flip_bits):
                rows = npr.integers(0, K, K)
                cols = npr.integers(0, 32, K)
                desc[rows, cols] ^= np.uint8(1 << int(npr.integers(0, 8)))
            descriptors[r, k] = desc
            pts_w = place_pts[p] + npr.normal(
                0, landmark_noise, (K, 3)).astype(np.float32)
            pts_c = np.einsum("ji,kj->ki", R_gt[r, k], pts_w - t_gt[r, k])
            landmarks[r, k] = pts_c
            norms = np.linalg.norm(pts_c, axis=1, keepdims=True)
            bearings[r, k] = pts_c / np.maximum(norms, 1e-9)
            valid[r, k, :features] = True
    return World(R_gt, t_gt, descriptors, landmarks, bearings, valid,
                 place_of)
