"""Threefry2x32 key derivation and uniform draws in numpy: a frozen copy
of the counter-based RNG policy that the verification path samples its
RANSAC hypotheses with (the same words `jax.random.fold_in` /
`jax.random.uniform` give for a threefry2x32 key, partitionable layout).
Keys are uint32 arrays (..., 2)."""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The block function (20 rounds) on broadcasting uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def base_key(seed: int) -> np.ndarray:
    """The key of an integer seed: words (seed >> 32, seed mod 2^32)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    d = np.asarray(data).astype(np.int64) & 0xFFFFFFFF
    d = d.astype(np.uint32)
    a, b = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(d), d)
    return np.stack([a, b], axis=-1)


def derive(key: np.ndarray, *ids) -> np.ndarray:
    for i in ids:
        key = fold_in(key, i)
    return key


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """U[0, 1) float32 draws (..., *shape): element n in row-major order
    is made from threefry(key, (0, n))."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    cnt = np.arange(n, dtype=np.uint32)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None],
                        np.zeros_like(cnt), cnt)
    bits = (a ^ b) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    return f.reshape(key.shape[:-1] + shape)
