"""State carried across from the JAX package.

The JAX package hands its state over as numpy arrays and plain values
(this module imports neither jax nor that package): the keyframe stores,
the raw words of a threefry key (`jax.random.key_data(key)`), its
`FrontendConfig` and its BoW `Vocabulary`. What comes out computes the same
thing in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend.dlc import FrontendConfig
from .frontend.lcd import LcdParams
from .frontend.vocab import Vocabulary, _from_numpy


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
    names, its `lcd` parameters included) -> the port's."""
    fields = {f: getattr(cfg, f) for f in FrontendConfig._fields}
    fields["lcd"] = LcdParams(**{f: getattr(cfg.lcd, f)
                                 for f in LcdParams._fields})
    return FrontendConfig(**fields)


def vocabulary_from_numpy(k, depth, centroids, word_weights, node_valid,
                          device="cuda") -> Vocabulary:
    """The fields of the JAX package's `Vocabulary` as numpy arrays (per
    level (k^(l+1), 32) uint8 centroids and (k^(l+1),) bool validity,
    (k^depth,) float32 idf weights) -> the port's, on `device`."""
    if len(centroids) != depth or len(node_valid) != depth:
        raise ValueError("expected one centroid and one validity array "
                         "per level")
    for lvl, (c, v) in enumerate(zip(centroids, node_valid)):
        n = k ** (lvl + 1)
        if np.shape(c) != (n, 32) or np.shape(v) != (n,):
            raise ValueError(f"level {lvl}: expected ({n}, 32) centroids "
                             f"and ({n},) validity")
    if np.shape(word_weights) != (k ** depth,):
        raise ValueError(f"expected ({k ** depth},) word weights")
    return _from_numpy(k, depth, [np.asarray(c) for c in centroids],
                       np.asarray(word_weights),
                       [np.asarray(v) for v in node_valid], device)
