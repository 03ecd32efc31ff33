"""Feature detection and tracking (the JAX package's vio/tracking.py).

Role of Kimera-VIO's `Tracker::featureTracking` (pyramidal KLT) and
`FeatureDetector::featureDetection` (GFTT with non-max suppression).
Gradients and structure tensors are whole-image convolutions and a max
pool; KLT runs a fixed number of iterations per pyramid level, vectorised
over the features, with bilinear patch samples
(`_sample.map_coordinates`). Everything is fixed shape: feature slots are
masked, not resized.

Ties: GFTT takes the top N of all H x W scores, most of them exactly 0,
with `jax.lax.top_k`'s order (a stable descending sort: the lower pixel
index first among equal scores), so the same pixels fill the invalid
slots on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._sample import map_coordinates

_SOBEL_X = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                        dtype=torch.float32) / 8.0


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Same-padding 2D cross-correlation of (H, W) with an odd (k, k)."""
    k = kernel.to(img.device)
    return F.conv2d(img[None, None], k[None, None],
                    padding=k.shape[-1] // 2)[0, 0]


def gradients(img: torch.Tensor):
    return _conv2(img, _SOBEL_X), _conv2(img, _SOBEL_X.T.contiguous())


class GfttParams(NamedTuple):
    max_features: int = 300  # maxFeaturesPerFrame
    quality_level: float = 0.001
    min_distance: int = 20
    block_size: int = 3
    nr_horizontal_bins: int = 7
    nr_vertical_bins: int = 5


def gftt_detect(img: torch.Tensor, params: GfttParams = GfttParams()):
    """Good-features-to-track corners.

    Returns (pts (N, 2) float32 as (x, y), scores (N,), valid (N,)) with
    N = max_features: the N best minimum-eigenvalue scores among pixels
    that are the maximum of their (min_distance | 1)^2 neighbourhood
    (padding -inf) and above quality_level x the image's best."""
    H, W = img.shape
    Ix, Iy = gradients(img)
    b = params.block_size
    box = torch.ones((b, b), dtype=torch.float32) / (b * b)
    Sxx = _conv2(Ix * Ix, box)
    Syy = _conv2(Iy * Iy, box)
    Sxy = _conv2(Ix * Iy, box)
    tr = Sxx + Syy
    d = Sxx - Syy
    det_part = torch.sqrt(torch.clamp(d * d + 4 * Sxy * Sxy, min=0.0))
    lam_min = 0.5 * (tr - det_part)

    k = params.min_distance | 1
    local_max = F.max_pool2d(lam_min[None, None], k, stride=1,
                             padding=k // 2)[0, 0]
    thresh = params.quality_level * torch.max(lam_min)
    is_corner = (lam_min >= local_max) & (lam_min > thresh)
    scores = torch.where(is_corner, lam_min, 0.0).reshape(-1)
    top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
    N = params.max_features
    top_scores, top_idx = top_scores[:N], top_idx[:N]
    yy = torch.div(top_idx, W, rounding_mode="floor").to(torch.float32)
    xx = (top_idx % W).to(torch.float32)
    return torch.stack([xx, yy], dim=-1), top_scores, top_scores > 0.0


def build_pyramid(img: torch.Tensor, levels: int):
    """Average-pool pyramid [img, /2, /4, ...]: each level the 2 x 2 sums
    of the previous one (cropped to even sizes) divided by 4."""
    pyr = [img]
    for _ in range(levels - 1):
        cur = pyr[-1]
        h2, w2 = cur.shape[0] // 2 * 2, cur.shape[1] // 2 * 2
        c = cur[:h2, :w2]
        # the window's sum in row-major order, as reduce_window adds it
        s = ((c[0::2, 0::2] + c[0::2, 1::2]) + c[1::2, 0::2]) + c[1::2, 1::2]
        pyr.append(s / 4.0)
    return pyr


class KltParams(NamedTuple):
    win_size: int = 24  # klt_win_size (uses win//2 half-window)
    max_iter: int = 30  # klt_max_iter
    max_level: int = 4  # klt_max_level
    eps: float = 0.1  # klt_eps (pixel update norm)
    min_eig: float = 1e-4  # tracking-quality gate


def _patch_offsets(half: int, device):
    r = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    return torch.meshgrid(r, r, indexing="ij")  # (dy, dx)


def _gather_patch(img, center, offsets):
    """Bilinear (2 half + 1)^2 patches around centers (N, 2) as (x, y):
    (N, 2 half + 1, 2 half + 1), zero outside the image; `offsets` the
    patch's (dy, dx) grid (`_patch_offsets`)."""
    dy, dx = offsets
    ys = center[:, 1, None, None] + dy
    xs = center[:, 0, None, None] + dx
    return map_coordinates(img, ys, xs, mode="constant", cval=0.0)


def klt_track(img0: torch.Tensor, img1: torch.Tensor, pts: torch.Tensor,
              valid: torch.Tensor, params: KltParams = KltParams()):
    """Pyramidal inverse-compositional Lucas-Kanade.

    pts (N, 2) in img0, valid (N,). Returns (pts1 (N, 2), tracked (N,)
    bool). A feature whose 2 x 2 normal matrix is near-singular at some
    level, or that ends outside the image, is dropped. Each level runs
    max_iter iterations with no early exit."""
    half = params.win_size // 2
    pyr0 = build_pyramid(img0, params.max_level)
    pyr1 = build_pyramid(img1, params.max_level)
    H, W = img0.shape
    offsets = _patch_offsets(half, img0.device)
    flow = torch.zeros_like(pts)
    good = valid
    for lvl in range(params.max_level - 1, -1, -1):
        scale = 2.0 ** lvl
        i0, i1 = pyr0[lvl], pyr1[lvl]
        c0 = pts / scale
        T = _gather_patch(i0, c0, offsets)
        # template gradients: central differences that wrap around the
        # patch edge (jnp.roll on the patch)
        gx = (torch.roll(T, -1, 2) - torch.roll(T, 1, 2)) * 0.5
        gy = (torch.roll(T, -1, 1) - torch.roll(T, 1, 1)) * 0.5
        A11 = torch.sum(gx * gx, dim=(1, 2))
        A12 = torch.sum(gx * gy, dim=(1, 2))
        A22 = torch.sum(gy * gy, dim=(1, 2))
        det = A11 * A22 - A12 * A12
        tr = A11 + A22
        lam_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det,
                                                     min=0.0)))
        solvable = lam_min > params.min_eig * (half * 2 + 1) ** 2
        inv_det = 1.0 / torch.clamp(det, min=1e-12)
        fl = flow / scale
        for _ in range(params.max_iter):
            e = _gather_patch(i1, c0 + fl, offsets) - T
            b1 = torch.sum(gx * e, dim=(1, 2))
            b2 = torch.sum(gy * e, dim=(1, 2))
            dx = (A22 * b1 - A12 * b2) * inv_det
            dy = (A11 * b2 - A12 * b1) * inv_det
            fl = fl - torch.stack([dx, dy], dim=-1)
        flow = torch.where(solvable[:, None], fl * scale, flow)
        good = good & solvable
    new_pt = pts + flow
    inb = ((new_pt[:, 0] >= half) & (new_pt[:, 0] < W - half)
           & (new_pt[:, 1] >= half) & (new_pt[:, 1] < H - half))
    return new_pt, good & inb
