"""Front-end configuration and loop-closure records (the `FrontendConfig`
and `VerifiedLC` of the JAX package's frontend/dlc.py; the sequential
orchestrator and the pose-graph builder follow with the back-end)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .lcd import LcdParams


class FrontendConfig(NamedTuple):
    lcd: LcdParams = LcdParams()
    bow_capacity: int = 128  # words per BoW vector
    lowe_ratio: float = 0.7
    ransac_hyp: int = 500
    mono_threshold: float = 1e-6
    stereo_threshold: float = 0.3
    min_mono_inliers: int = 10
    min_stereo_inliers: int = 5
    kappa_lc: float = 1e4
    tau_lc: float = 1e2
    kappa_odo: float = 1e4
    tau_odo: float = 1e2
    min_intra_separation: int = 10  # skip near-diagonal self matches
    # 5-pt minimal mono gate by default (ransac_essential_5pt), as in the
    # JAX package; use_5pt=False takes the 8-point gate
    use_5pt: bool = True
    base_seed: int = 0


class VerifiedLC(NamedTuple):
    robot_a: int
    frame_a: int
    robot_b: int
    frame_b: int
    R: np.ndarray  # T^a_b (pose of b's frame expressed in a)
    t: np.ndarray
    mono_inliers: int
    stereo_inliers: int
    bow_score: float
    status: int
    accepted: bool
