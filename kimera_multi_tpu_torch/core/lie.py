"""SE(3) helpers (the part of the JAX package's core/lie.py that the
verification path calls)."""

from __future__ import annotations

import torch


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    """Inverse of the rigid transform x -> R x + t.
    R (..., 3, 3), t (..., 3)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)
