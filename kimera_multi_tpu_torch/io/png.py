"""Minimal dependency-free PNG writer + 5x7 bitmap annotations. A copy of
the JAX package's io/png.py, which is numpy only; the port keeps its own.

Role of the OpenCV imwrite/putText pair used by the reference's
loop-closure image-evidence tool (evaluation/extract_lc_images.py:
135-175 merges the two keyframe images side by side and overlays the
distance/score/inlier counts). The package needs neither cv2 nor PIL: this
writes PNGs from raw numpy via zlib and renders the annotation strip
with an embedded 5x7 font.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W) or (H, W, 3) uint8."""
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    if not (img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# 5x7 glyphs (row-major bit strings) — just what annotations need
_FONT = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11110 00001 00001 01110 00001 00001 11110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    "-": "00000 00000 00000 01110 00000 00000 00000",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    " ": "00000 00000 00000 00000 00000 00000 00000",
    "m": "00000 00000 11010 10101 10101 10101 10101",
    "d": "00001 00001 01101 10011 10001 10011 01101",
    "r": "00000 00000 10110 11001 10000 10000 10000",
    "f": "00110 01000 11110 01000 01000 01000 01000",
    "s": "00000 00000 01111 10000 01110 00001 11110",
    "t": "00100 00100 11111 00100 00100 00100 00011",
    "i": "00100 00000 01100 00100 00100 00100 01110",
    "n": "00000 00000 11110 10001 10001 10001 10001",
    "l": "01100 00100 00100 00100 00100 00100 01110",
    "o": "00000 00000 01110 10001 10001 10001 01110",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "x": "00000 00000 10001 01010 00100 01010 10001",
}


def render_text(text: str, scale: int = 1) -> np.ndarray:
    """(7*scale, 6*len*scale) uint8 bitmap, white on black."""
    cols = []
    for ch in text:
        g = _FONT.get(ch.lower(), _FONT[" "]).split()
        glyph = np.asarray([[int(b) for b in row] for row in g], np.uint8)
        cols.append(np.pad(glyph, ((0, 0), (0, 1))))
    img = np.concatenate(cols, axis=1) * 255
    if scale > 1:
        img = img.repeat(scale, axis=0).repeat(scale, axis=1)
    return img


def annotate_pair(img1: np.ndarray, img2: np.ndarray, caption: str,
                  divider: int = 4) -> np.ndarray:
    """Side-by-side uint8 grayscale pair with a caption strip on top
    (the reference merges the two keyframe images and overlays the
    metadata, extract_lc_images.py:137-171)."""
    h = max(img1.shape[0], img2.shape[0])

    def fit(im):
        if im.shape[0] < h:
            im = np.pad(im, ((0, h - im.shape[0]), (0, 0)))
        return im

    pair = np.concatenate(
        [fit(img1), np.full((h, divider), 255, np.uint8), fit(img2)],
        axis=1)
    strip = render_text(caption)
    sh, sw = strip.shape
    bar = np.zeros((sh + 4, pair.shape[1]), np.uint8)
    bar[2:2 + sh, 2:2 + min(sw, pair.shape[1] - 2)] = \
        strip[:, : pair.shape[1] - 2]
    return np.concatenate([bar, pair], axis=0)
