"""State carried across from the JAX package.

The JAX package hands its state over as numpy arrays and plain values
(this module imports neither jax nor that package): the keyframe stores,
the raw words of a threefry key (`jax.random.key_data(key)`), and its
`FrontendConfig`. What comes out computes the same thing in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend.dlc import FrontendConfig


def stores_from_numpy(desc, obs_valid, bearings, landmarks, device="cuda"):
    """Keyframe stores as contiguous tensors on `device`:
    desc (R, T, K, 32) uint8, obs_valid (R, T, K) bool, bearings /
    landmarks (R, T, 3, K) f32 coordinate-major."""
    desc = np.ascontiguousarray(desc, np.uint8)
    obs_valid = np.ascontiguousarray(obs_valid, bool)
    bearings = np.ascontiguousarray(bearings, np.float32)
    landmarks = np.ascontiguousarray(landmarks, np.float32)
    R, T, K, nb = desc.shape
    if nb != 32 or obs_valid.shape != (R, T, K) \
            or bearings.shape != (R, T, 3, K) \
            or landmarks.shape != (R, T, 3, K):
        raise ValueError("stores do not have the (R, T, K, 32) / (R, T, K) "
                         "/ (R, T, 3, K) layout")
    return tuple(torch.from_numpy(a).to(device)
                 for a in (desc, obs_valid, bearings, landmarks))


def key_from_jax_key_data(key_data, device="cpu") -> torch.Tensor:
    """The two uint32 words of a threefry2x32 key -> the port's key."""
    words = np.asarray(key_data)
    if words.shape[-1] != 2:
        raise ValueError("expected the (..., 2) uint32 words of a "
                         "threefry2x32 key")
    return torch.from_numpy(words.astype(np.int64)).to(device)


def config_from_jax(cfg) -> FrontendConfig:
    """The JAX package's FrontendConfig (any object with the same field
    names) -> the port's. The `lcd` parameters are carried as they are."""
    return FrontendConfig(**{f: getattr(cfg, f)
                             for f in FrontendConfig._fields})
