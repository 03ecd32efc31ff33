"""Synthetic textured-scene renderer for VIO (the JAX package's
io/render.py).

A 3D point-sprite world projected through a pinhole (+ optional radtan
distortion) stereo rig along an analytic trajectory, with consistent IMU
measurements (gyro / accel in the body frame, gravity included). The
scene, the trajectory and the IMU are numpy, copied from the JAX package;
each image is made on the device as one product of the sprites' vertical
and horizontal Gaussian profiles, (P, H)^T (P, W), and comes back to the
host as numpy (`RenderedSequence` holds numpy arrays).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import backend
from ..vio.undistort import CameraModel, distort_normalized


class Scene(NamedTuple):
    points: np.ndarray  # (P, 3) world
    intensity: np.ndarray  # (P,)


class StereoRig(NamedTuple):
    cam: CameraModel
    H: int
    W: int
    baseline: float  # right camera at +x_cam * baseline


def make_scene(seed: int = 0, n_points: int = 400,
               extent=(14.0, 14.0, 5.0), center=(6.0, 3.0, 0.0)) -> Scene:
    """Point sprites filling a box around/ahead of the trajectory (world:
    z up, trajectory in the x-y plane starting at the origin heading +x)."""
    npr = np.random.default_rng(seed)
    e = np.asarray(extent)
    c = np.asarray(center)
    pts = npr.uniform(-0.5, 0.5, (n_points, 3)) * e + c
    inten = npr.uniform(0.4, 1.0, n_points)
    return Scene(points=pts.astype(np.float32),
                 intensity=inten.astype(np.float32))


def render(points, intensity, R, t, cam: CameraModel, H: int, W: int,
           sigma: float, distort: bool) -> torch.Tensor:
    """World points (P, 3), intensities (P,) -> (H, W) image from camera
    pose (R, t) = world <- cam, all tensors on one device."""
    Xc = torch.sum(R * (points - t)[:, :, None], dim=1)  # R^T (p - t)
    z = Xc[:, 2]
    ok = z > 0.3
    zc = torch.clamp(z, min=0.3)
    xn, yn = Xc[:, 0] / zc, Xc[:, 1] / zc
    if distort:
        xn, yn = distort_normalized(xn, yn, cam)
    u = xn * cam.fx + cam.cx
    v = yn * cam.fy + cam.cy
    w = torch.where(ok, intensity * 4.0 / zc, 0.0)
    dev = points.device
    us = torch.arange(W, dtype=torch.float32, device=dev)
    vs = torch.arange(H, dtype=torch.float32, device=dev)
    du = us[None, :] - u[:, None]  # (P, W)
    dv = vs[None, :] - v[:, None]  # (P, H)
    g_u = torch.exp(-(du * du) / (2 * sigma * sigma))
    g_v = torch.exp(-(dv * dv) / (2 * sigma * sigma))
    # image = sum_p w_p g_v[p] (x) g_u[p]: one product
    return (g_v * w[:, None]).T @ g_u


class RenderedSequence(NamedTuple):
    left: np.ndarray  # (F, H, W) f32
    right: np.ndarray  # (F, H, W)
    timestamps: np.ndarray  # (F,)
    R_gt: np.ndarray  # (F, 3, 3) world<-body
    t_gt: np.ndarray  # (F, 3)
    imu_ts: np.ndarray  # (M,)
    gyro: np.ndarray  # (M, 3) body rates
    accel: np.ndarray  # (M, 3) specific force (incl. gravity)


def circular_trajectory(n_frames: int, rate_hz: float = 20.0,
                        speed: float = 0.8, yaw_rate: float = 0.15):
    """Constant-speed arc in the x-y plane (world z up), camera optical
    axis (z_cam) = heading, y_cam = down = -z_world, x_cam = right.

    Body frame = camera frame (x right, y down, z forward)."""
    ts = np.arange(n_frames) / rate_hz
    yaw = yaw_rate * ts
    if yaw_rate > 1e-9:
        t = np.stack([
            speed / yaw_rate * np.sin(yaw),
            speed / yaw_rate * (1 - np.cos(yaw)),
            np.zeros_like(ts),
        ], axis=-1)
    else:
        t = np.stack([speed * ts, np.zeros_like(ts), np.zeros_like(ts)],
                     axis=-1)
    R = np.zeros((n_frames, 3, 3), np.float32)
    cy, sy = np.cos(yaw), np.sin(yaw)
    # columns (world<-cam): x_cam=(sy,-cy,0), y_cam=(0,0,-1), z_cam=(cy,sy,0)
    R[:, 0, 0], R[:, 1, 0] = sy, -cy
    R[:, 2, 1] = -1.0
    R[:, 0, 2], R[:, 1, 2] = cy, sy
    return ts, R.astype(np.float32), t.astype(np.float32)


GRAVITY_W = np.asarray([0.0, 0.0, -9.81], np.float32)  # matches vio.imu


def render_sequence(scene: Scene, rig: StereoRig, n_frames: int = 40,
                    rate_hz: float = 20.0, imu_rate_hz: float = 200.0,
                    speed: float = 0.8, yaw_rate: float = 0.15,
                    sigma: float = 1.6, distort: bool = False,
                    imu_noise: float = 0.0, seed: int = 0,
                    device="cuda") -> RenderedSequence:
    """The stereo images along `circular_trajectory`, rendered on
    `device`, and the analytic IMU."""
    dev = backend.resolve_device(device)
    ts, R_gt, t_gt = circular_trajectory(n_frames, rate_hz, speed, yaw_rate)
    pts = torch.from_numpy(scene.points).to(dev)
    inten = torch.from_numpy(scene.intensity).to(dev)
    Rs = torch.from_numpy(R_gt).to(dev)
    tl = torch.from_numpy(t_gt).to(dev)
    base = torch.tensor([rig.baseline, 0.0, 0.0], dtype=torch.float32,
                        device=dev)
    tr = tl + torch.sum(Rs * base, dim=-1)  # t + R [b, 0, 0]
    left = torch.empty((n_frames, rig.H, rig.W), dtype=torch.float32)
    right = torch.empty_like(left)
    for k in range(n_frames):
        for out, tk in ((left, tl[k]), (right, tr[k])):
            out[k] = render(pts, inten, Rs[k], tk, rig.cam, rig.H, rig.W,
                            sigma, distort).cpu()

    # analytic IMU: constant speed on the arc -> body rates are constant
    m = int(n_frames / rate_hz * imu_rate_hz)
    imu_ts = (np.arange(m) + 1) / imu_rate_hz
    npr = np.random.default_rng(seed + 1)
    # gyro: yawing about world +z = about body -y (y_cam = -z_world)
    gyro = np.tile(np.asarray([0.0, -yaw_rate, 0.0], np.float32), (m, 1))
    # accel: specific force f_b = R^T (a_w - g_w); centripetal a_w points
    # to the arc center with magnitude v*omega
    yaw_i = yaw_rate * imu_ts
    a_w = (speed * yaw_rate) * np.stack(
        [-np.sin(yaw_i), np.cos(yaw_i), np.zeros_like(yaw_i)], -1)
    cy, sy = np.cos(yaw_i), np.sin(yaw_i)
    f = np.zeros((m, 3), np.float32)
    rel = a_w - GRAVITY_W[None]
    # R^T rows: x_cam=(sy,-cy,0), y_cam=(0,0,-1), z_cam=(cy,sy,0)
    f[:, 0] = sy * rel[:, 0] - cy * rel[:, 1]
    f[:, 1] = -rel[:, 2]
    f[:, 2] = cy * rel[:, 0] + sy * rel[:, 1]
    if imu_noise > 0:
        gyro = gyro + npr.normal(0, imu_noise, gyro.shape).astype(np.float32)
        f = f + npr.normal(0, imu_noise * 10, f.shape).astype(np.float32)
    return RenderedSequence(
        left=left.numpy(), right=right.numpy(), timestamps=ts,
        R_gt=R_gt, t_gt=t_gt, imu_ts=imu_ts.astype(np.float64),
        gyro=gyro.astype(np.float32), accel=f.astype(np.float32))
