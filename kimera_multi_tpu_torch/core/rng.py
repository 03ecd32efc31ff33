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


# XLA's float32 erfinv (M. Giles' single-precision polynomials, for
# w = -log1p(-x^2) below and above 5), the function `jax.random.normal`
# calls; `torch.special.erfinv` is another approximation.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA writes it. Each Horner step c + p w is one
    fused multiply-add, as XLA's CPU code contracts it: p w is exact in
    float64 and the sum is rounded once more to float32."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GT5, dtype=torch.float32, device=x.device)
    coef = torch.where(lt[..., None], lo, hi).to(torch.float64)
    w64 = w.to(torch.float64)
    p = coef[..., 0].to(torch.float32)
    for i in range(1, coef.shape[-1]):
        p = (coef[..., i] + p.to(torch.float64) * w64).to(torch.float32)
    return torch.where(torch.abs(x) == 1, x * math.inf, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32 draws, key (..., 2) -> (..., *shape), as
    `jax.random.normal` makes them: a uniform on (nextafter(-1, 0), 1)
    from the same bits as `uniform`, then sqrt(2) erfinv. Against JAX on
    the CPU a draw differs by at most 3 ulp (XLA's own log1p), in about 1
    of 100 draws."""
    lo = -0.99999994  # nextafter(-1, 0) in float32
    u = torch.clamp(uniform(key, shape) * 2.0 + lo, min=lo)
    return math.sqrt(2.0) * _erfinv_f32(u)
