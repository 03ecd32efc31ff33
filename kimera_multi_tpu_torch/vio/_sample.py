"""Bilinear sampling of a 2D image at arbitrary coordinates, as
`jax.scipy.ndimage.map_coordinates(img, [ys, xs], order=1, mode=...)`
computes it (the JAX package's tracking, descriptor and undistortion
code call it).

Per axis: the lower index is floor(c), the upper one floor(c) + 1, with
weights 1 - (c - floor(c)) and c - floor(c). The four corners are taken in
the order (lower y, lower x), (lower y, upper x), (upper y, lower x),
(upper y, upper x); each contributes (w_y * w_x) * value and the
contributions are summed in that order. mode "nearest" clips each index
into the image; mode "constant" gives a corner outside the image the value
`cval`. Written this way and not with `grid_sample`, whose normalised
coordinates round the pixel position differently.
"""

from __future__ import annotations

import torch


def map_coordinates(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    mode: str = "constant", cval: float = 0.0
                    ) -> torch.Tensor:
    """img (H, W); ys, xs float32 of one shape (row and column
    coordinates). Returns the bilinear samples in that shape."""
    if mode not in ("constant", "nearest"):
        raise ValueError(f"mode {mode!r}: only 'constant' and 'nearest'")
    H, W = img.shape
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0f, xs - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    if mode == "constant":
        # a border of cval around the image: an index clamped into
        # [-1, size] reads the pixel itself, or cval where the index lies
        # outside the image (every index < 0 or >= size reads the border)
        src = torch.nn.functional.pad(img, (1, 1, 1, 1), value=cval)
        lo, hi, shift = -1, (H, W), 1
    else:
        src, lo, hi, shift = img, 0, (H - 1, W - 1), 0
    flat = src.reshape(-1)
    stride = W + 2 * shift
    rows = [(torch.clamp(y0 + d, lo, hi[0]) + shift) * stride
            for d in (0, 1)]
    cols = [torch.clamp(x0 + d, lo, hi[1]) + shift for d in (0, 1)]
    out = None
    for r, wy in zip(rows, (wy0, wy1)):
        for c, wx in zip(cols, (wx0, wx1)):
            term = (wy * wx) * flat[r + c]
            out = term if out is None else out + term
    return out
