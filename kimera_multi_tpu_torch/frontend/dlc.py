"""Front-end configuration (the `FrontendConfig` of the JAX package's
frontend/dlc.py; the orchestrator around it is not ported yet)."""

from __future__ import annotations

from typing import Any, NamedTuple


class FrontendConfig(NamedTuple):
    # loop-closure-detection parameters; the detection side is not ported
    # yet, so nothing here reads them
    lcd: Any = None
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
