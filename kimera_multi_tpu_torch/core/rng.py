"""Deterministic counter-based RNG policy: threefry2x32 written in torch.

Every random draw of the verification path is keyed by a structural
address (robot, keyframe, target, match, purpose) through threefry
fold-ins, so results do not depend on execution order or on how
candidates are batched. A `torch.Generator` cannot give per-candidate,
batch-independent draws, so this module carries its own threefry2x32,
vectorised over a batch of keys, and reproduces bit for bit what
`jax.random.fold_in` / `jax.random.uniform` give for a threefry2x32 key
(partitionable counter layout): a sample table drawn here equals the one
the JAX package draws from the same key.

A key is an int64 tensor (..., 2) holding two 32-bit words (torch's uint32
arithmetic is incomplete, so words live in int64 and are masked).
"""

from __future__ import annotations

from enum import IntEnum
import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class Stream(IntEnum):
    """Purpose tags so different subsystems never collide on a key."""

    RANSAC_MONO = 0
    RANSAC_STEREO = 1
    LIFTING = 2
    INIT = 3
    VOCAB = 4
    SIM = 5
    VIO = 6


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function (20 rounds). All arguments are int64
    tensors of 32-bit words that broadcast; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def base_key(seed: int, device="cpu") -> torch.Tensor:
    """Key of an integer seed: the words (0, seed)."""
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """key (..., 2), data an int or an integer tensor broadcasting against
    the key's batch shape (taken modulo 2**32). Returns (..., 2)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    d = data.to(device=key.device, dtype=torch.int64) & _M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def derive(key: torch.Tensor, *ids) -> torch.Tensor:
    """Fold a sequence of integer ids (robot, kf, Stream, ...) into a key.
    Each id is a python int or an integer tensor over the batch."""
    for i in ids:
        key = fold_in(key, i)
    return key


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """U[0, 1) float32 draws: key (..., 2) -> (..., *shape). Element n (in
    row-major order over `shape`) is made from threefry(key, (0, n))."""
    shape = tuple(shape)
    n = math.prod(shape)
    assert n < 2 ** 32
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    k0 = key[..., 0].unsqueeze(-1)
    k1 = key[..., 1].unsqueeze(-1)
    a, b = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    bits = a ^ b
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(key.shape[:-1] + shape)
