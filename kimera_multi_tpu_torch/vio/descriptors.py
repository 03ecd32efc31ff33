"""Binary keypoint descriptors (the JAX package's vio/descriptors.py).

The ORB role in the LCD data path: (N, 32) packed uint8, 256 bits per
keypoint, from a BRIEF-style pair test on the 5 x 5 box-smoothed image
with a fixed, seed-derived sampling pattern (the same numbers as the JAX
package's), all keypoints in one batch of bilinear samples
(`_sample.map_coordinates`, mode "nearest"). No rotation steering.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._sample import map_coordinates

_N_BITS = 256
_PATCH = 24  # sampling diameter in pixels


def _pattern(seed: int = 7):
    """Fixed BRIEF pattern: 256 Gaussian-distributed point pairs."""
    npr = np.random.default_rng(seed)
    sigma = _PATCH / 5.0
    a = np.clip(npr.normal(0, sigma, (_N_BITS, 2)), -_PATCH / 2, _PATCH / 2)
    b = np.clip(npr.normal(0, sigma, (_N_BITS, 2)), -_PATCH / 2, _PATCH / 2)
    return a.astype(np.float32), b.astype(np.float32)


_PAT_A, _PAT_B = _pattern()
_BIT_W = (1 << np.arange(8)).astype(np.int32)  # LSB-first byte packing


def describe(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor
             ) -> torch.Tensor:
    """(H, W) image + (N, 2) keypoints (x, y) -> (N, 32) packed uint8.
    Invalid slots give zero bytes."""
    dev = img.device
    k = torch.full((1, 1, 5, 5), 1.0 / 25.0, dtype=torch.float32,
                   device=dev)
    sm = F.conv2d(img[None, None], k, padding=2)[0, 0]
    pa = torch.from_numpy(_PAT_A).to(dev)
    pb = torch.from_numpy(_PAT_B).to(dev)
    x, y = pts[:, 0, None], pts[:, 1, None]
    ia = map_coordinates(sm, y + pa[:, 1], x + pa[:, 0], mode="nearest")
    ib = map_coordinates(sm, y + pb[:, 1], x + pb[:, 0], mode="nearest")
    bits = (ia < ib).to(torch.int32).reshape(-1, 32, 8)
    w = torch.from_numpy(_BIT_W).to(dev)
    bytes_ = torch.sum(bits * w, dim=-1)
    return torch.where(valid[:, None], bytes_, 0).to(torch.uint8)
