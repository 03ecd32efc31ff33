"""Camera undistortion / rectification (the JAX package's vio/undistort.py).

Radtan (plumb-bob) model. The remap grid is computed once by fixed-point
inversion of the distortion over every pixel; applying it is one bilinear
sample per pixel (`_sample.map_coordinates`, mode "constant").
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._sample import map_coordinates


class CameraModel(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


def distort_normalized(x: torch.Tensor, y: torch.Tensor, cam: CameraModel):
    """Apply radtan distortion to normalized coordinates."""
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return xd, yd


def _invert(x, y, cam: CameraModel, iters: int):
    """Fixed-point inversion of the distortion: undistorted normalized
    coordinates whose distortion is (x, y)."""
    xc, yc = x, y
    for _ in range(iters):
        xd, yd = distort_normalized(xc, yc, cam)
        xc, yc = xc - (xd - x), yc - (yd - y)
    return xc, yc


def undistort_map(cam: CameraModel, H: int, W: int, iters: int = 8,
                  device="cpu"):
    """Remap grid: for each RECTIFIED pixel, the distorted source pixel
    (map_u, map_v), each (H, W)."""
    us = (torch.arange(W, dtype=torch.float32, device=device) - cam.cx) \
        / cam.fx
    vs = (torch.arange(H, dtype=torch.float32, device=device) - cam.cy) \
        / cam.fy
    y, x = torch.meshgrid(vs, us, indexing="ij")
    xc, yc = _invert(x, y, cam, iters)
    xd, yd = distort_normalized(xc, yc, cam)
    return xd * cam.fx + cam.cx, yd * cam.fy + cam.cy


def remap(img: torch.Tensor, map_u: torch.Tensor, map_v: torch.Tensor):
    """Bilinear remap of an (H, W) image through the precomputed grid."""
    return map_coordinates(img, map_v, map_u, mode="constant", cval=0.0)


def undistort_points(pts: torch.Tensor, cam: CameraModel, iters: int = 8):
    """Undistort pixel points (N, 2) -> rectified pixels (N, 2)."""
    x = (pts[:, 0] - cam.cx) / cam.fx
    y = (pts[:, 1] - cam.cy) / cam.fy
    xu, yu = _invert(x, y, cam, iters)
    return torch.stack([xu * cam.fx + cam.cx, yu * cam.fy + cam.cy], -1)
