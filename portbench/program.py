"""The system under test: `make_verifier`'s `verify_many` of the
PyTorch/CUDA port, fed a backlog chunk by chunk. The only module of the
benchmark that imports the port.

Besides the chunk's results the harness keeps the match table that the
2-NN + Lowe step produced inside the call (a reference to the tensor the
program made; nothing is copied or launched for it).
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_multi_tpu_torch.frontend import batched
from kimera_multi_tpu_torch.frontend.dlc import FrontendConfig
from kimera_multi_tpu_torch.kernels import _build, hamming

_SOLVERS = {"stewenius_5pt": True, "eight_point": False}


def frontend_config(cfg: dict) -> FrontendConfig:
    """The port's FrontendConfig for a configuration file."""
    if cfg["mono_solver"] not in _SOLVERS:
        raise ValueError(f"the port has no mono solver {cfg['mono_solver']}")
    return FrontendConfig(
        lowe_ratio=cfg["lowe_ratio"], ransac_hyp=cfg["ransac_hypotheses"],
        mono_threshold=cfg["mono_threshold"],
        stereo_threshold=cfg["stereo_threshold"],
        min_mono_inliers=cfg["min_mono_inliers"],
        min_stereo_inliers=cfg["min_stereo_inliers"],
        use_5pt=_SOLVERS[cfg["mono_solver"]])


class Program:
    """The verifier of one configuration over one world's keyframe stores,
    on `device`. Use as a context manager: the match-table hook is
    removed on exit."""

    def __init__(self, cfg: dict, world, base_key: np.ndarray, device):
        self.device = torch.device(device)
        self.verify_many = batched.make_verifier(frontend_config(cfg),
                                                 device=self.device)
        dev = self.device
        self.stores = (
            torch.from_numpy(world.descriptors).to(dev).contiguous(),
            torch.from_numpy(world.obs_valid).to(dev).contiguous(),
            torch.from_numpy(world.bearings).to(dev).transpose(
                -1, -2).contiguous(),
            torch.from_numpy(world.landmarks).to(dev).transpose(
                -1, -2).contiguous())
        self.key = torch.from_numpy(base_key.astype(np.int64)).to(dev)
        self._tables: list = []
        self._orig = None

    def __enter__(self):
        orig = self._orig = hamming.knn2_lowe_match_pairs
        tables = self._tables

        def knn2_lowe_match_pairs(*a, **k):
            out = orig(*a, **k)
            tables.append(out[0])
            return out

        hamming.knn2_lowe_match_pairs = knn2_lowe_match_pairs
        return self

    def __exit__(self, *exc):
        hamming.knn2_lowe_match_pairs = self._orig
        self._tables.clear()

    def call(self, arrays):
        """Launch one chunk: arrays = (qr, qf, tr, tm) numpy int64, as the
        front-end hands them. Returns the result tensors (not yet read
        back) and the match table."""
        out = self.verify_many(self.key, *self.stores, *arrays)
        return out, self._tables.pop()

    @staticmethod
    def read_back(out: dict, n: int) -> dict:
        """The first n results on the host, as `verify_candidates` reads
        them."""
        return {k: v[:n].cpu().numpy() for k, v in out.items()}

    @staticmethod
    def launches() -> dict:
        """The port's per-kernel launch counters (hand-written kernels)."""
        return dict(_build.launches)

    def free(self):
        self.stores = None
        self.verify_many = None
