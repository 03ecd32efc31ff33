"""Metric-semantic TSDF integration on a fixed dense voxel grid (the JAX
package's semantics/tsdf.py).

The projective-TSDF update runs over all voxels at once: each voxel
projects into the current depth image, reads the measured depth and
blends a truncated SDF. Semantic labels fuse as per-voxel class
histograms, hardened by argmax at extraction. Surface extraction emits one
zero-crossing vertex per sign-change voxel, with normals.

Everything is elementwise PyTorch on the grid's device, written so that
the card and the CPU give the same bits: the camera-frame rotation is
rows of products summed left to right (no matmul), the scatters are
min / max (independent of the order of arrival), pixel coordinates are
clamped in float before the integer conversion (a saturating conversion
on the card, an undefined one on the CPU for values past int32), and the
surface's top-k is a stable descending sort (`jax.lax.top_k` order: the
lower index first among equal scores).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.backend import resolve_device
from ..frontend.lcd import _topk


class TsdfGrid(NamedTuple):
    tsdf: torch.Tensor  # (X, Y, Z) float32, initialized at +trunc
    weight: torch.Tensor  # (X, Y, Z) float32
    sem_hist: torch.Tensor  # (X, Y, Z, C) float32 class histogram
    origin: torch.Tensor  # (3,) world position of voxel (0, 0, 0)
    voxel_size: float
    trunc: float


def make_grid(shape, origin, voxel_size: float, trunc: float,
              n_classes: int = 8, device="cuda") -> TsdfGrid:
    """An empty grid on `device` (the card unless told otherwise)."""
    dev = resolve_device(device)
    X, Y, Z = shape
    return TsdfGrid(
        tsdf=torch.full(tuple(shape), float(trunc), device=dev),
        weight=torch.zeros(tuple(shape), device=dev),
        sem_hist=torch.zeros((X, Y, Z, n_classes), device=dev),
        origin=torch.as_tensor(origin, dtype=torch.float32).to(dev),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
    )


def _pixel(u: torch.Tensor, size: int) -> torch.Tensor:
    """The integer pixel index of float coordinates u: truncation toward
    zero, clipped to [0, size - 1] (XLA's saturating conversion, then its
    clip), with the clamp taken in float first so that no conversion
    leaves the int32 range."""
    return torch.clamp(u, 0.0, float(size - 1)).to(torch.int64)


def depth_image_from_points(points_cam, labels, valid, H, W, fx, fy, cx, cy,
                            dilate: int = 0):
    """Bin a camera-frame point cloud (M, 3) into an (H, W) depth and label
    image (scatter-min on depth, scatter-max on labels). `dilate` > 0
    splats each point over a (2 dilate + 1)^2 neighbourhood (min-pool of
    the depth, max-pool of the labels), so that sparse landmark clouds give
    usable projective updates. Labels must be >= 0."""
    dev = points_cam.device
    z = points_cam[:, 2]
    ok = valid & (z > 1e-3)
    zs = torch.clamp(z, min=1e-6)
    u = _pixel(fx * points_cam[:, 0] / zs + cx, W)
    v = _pixel(fy * points_cam[:, 1] / zs + cy, H)
    flat = torch.where(ok, v * W + u, 0)
    big = 1e6
    depth = torch.full((H * W,), big, device=dev).scatter_reduce_(
        0, flat, torch.where(ok, z, big), "amin", include_self=True)
    lab = torch.zeros((H * W,), dtype=torch.int64, device=dev)
    lab = lab.scatter_reduce_(
        0, flat, torch.where(ok, labels.to(torch.int64), 0), "amax",
        include_self=True)
    depth = depth.reshape(H, W)
    lab = lab.reshape(H, W)
    if dilate > 0:
        k = 2 * dilate + 1
        # SAME windows: the pools' padding is never the extremum (depths
        # are <= big, labels >= 0); labels pool in float32, exact below
        # 2^24
        depth = -F.max_pool2d(-depth[None, None], k, stride=1,
                              padding=dilate)[0, 0]
        lab = F.max_pool2d(lab.to(torch.float32)[None, None], k, stride=1,
                           padding=dilate)[0, 0].to(torch.int64)
    depth = torch.where(depth >= big, 0.0, depth)
    return depth, lab.to(torch.int32)


def voxel_centers(grid: TsdfGrid) -> torch.Tensor:
    """(X, Y, Z, 3) world positions of the voxel centres."""
    X, Y, Z = grid.tsdf.shape
    dev = grid.tsdf.device
    ii, jj, kk = torch.meshgrid(torch.arange(X, device=dev),
                                torch.arange(Y, device=dev),
                                torch.arange(Z, device=dev), indexing="ij")
    ijk = torch.stack([ii, jj, kk], -1).to(torch.float32)
    return (ijk + 0.5) * grid.voxel_size + grid.origin


@torch.no_grad()
def integrate(grid: TsdfGrid, depth: torch.Tensor, label_img: torch.Tensor,
              R_wc: torch.Tensor, t_wc: torch.Tensor,
              fx: float, fy: float, cx: float, cy: float,
              max_weight: float = 100.0) -> TsdfGrid:
    """One projective TSDF update from a posed depth image.

    R_wc, t_wc: camera pose in the world (world <- cam). Every voxel:
    voxel -> camera frame -> pixel -> sdf = depth(pixel) - z_voxel.
    `max_weight` is accepted and unused, as in the JAX package.
    """
    H, W = depth.shape
    d = voxel_centers(grid) - t_wc
    # pc_i = sum_j R_wc[j, i] d_j (R_wc^T d), left to right
    R = R_wc.to(torch.float32)
    pc = [(R[0, i] * d[..., 0] + R[1, i] * d[..., 1]) + R[2, i] * d[..., 2]
          for i in range(3)]
    z = pc[2]
    zs = torch.clamp(z, min=1e-6)
    u = fx * pc[0] / zs + cx
    v = fy * pc[1] / zs + cy
    ui, vi = _pixel(u, W), _pixel(v, H)
    meas = depth[vi, ui]
    lab = label_img[vi, ui]
    in_view = ((z > 1e-2) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
               & (meas > 0))
    sdf = meas - z
    update = in_view & (sdf > -grid.trunc)
    sdf_c = torch.clamp(sdf, -grid.trunc, grid.trunc)
    w_new = torch.where(update, 1.0, 0.0)
    w_tot = grid.weight + w_new
    tsdf = torch.where(
        update,
        (grid.tsdf * grid.weight + sdf_c * w_new)
        / torch.clamp(w_tot, min=1e-6),
        grid.tsdf)
    # semantics: the histogram of near-surface voxels only
    near = update & (torch.abs(sdf) < grid.trunc * 0.5)
    C = grid.sem_hist.shape[-1]
    onehot = F.one_hot(torch.clamp(lab.to(torch.int64), 0, C - 1),
                       C).to(torch.float32)
    hist = grid.sem_hist + onehot * near[..., None]
    return grid._replace(tsdf=tsdf, weight=w_tot, sem_hist=hist)


@torch.no_grad()
def extract_surface(grid: TsdfGrid, max_vertices: int = 8192):
    """Zero-crossing surface extraction: one vertex per sign-change voxel
    (moved along the gradient to the sub-voxel crossing), with normals and
    hardened semantic labels; the max_vertices best by 1 / (1 + |tsdf|).
    Returns (verts (M, 3), normals (M, 3), labels (M,) int32, valid (M,))."""
    t = grid.tsdf
    observed = grid.weight > 0
    # gradient by central differences (wrapping at the borders, as JAX)
    g = [(torch.roll(t, -1, a) - torch.roll(t, 1, a)) * 0.5
         for a in range(3)]
    gn = torch.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2] + 1e-12)
    # a sign change against the +x / +y / +z neighbour
    sc = ((t * torch.roll(t, -1, 0) < 0)
          | (t * torch.roll(t, -1, 1) < 0)
          | (t * torch.roll(t, -1, 2) < 0))
    surf = sc & observed & (torch.abs(t) < grid.trunc)
    score = torch.where(surf, 1.0 / (1.0 + torch.abs(t)), 0.0).reshape(-1)
    top, idx = _topk(score, max_vertices)
    valid = top > 0
    # only the selected voxels' vertices and normals
    flat = lambda a: a.reshape(-1)[idx]  # noqa: E731
    t_s, gn_s = flat(t), flat(gn)
    nrm = torch.stack([flat(gi) / gn_s for gi in g], -1)
    step = -(t_s / torch.clamp(gn_s, min=1e-6))[:, None] * nrm
    verts = voxel_centers(grid).reshape(-1, 3)[idx] + step * grid.voxel_size
    C = grid.sem_hist.shape[-1]
    labels = torch.argmax(grid.sem_hist.reshape(-1, C)[idx], -1)
    return verts, nrm, labels.to(torch.int32), valid
