"""Batched loop-closure verification.

VERIFY stage of the batched front-end: ONE call over a candidate chunk
against the device-resident keyframe stores — pair Hamming 2-NN + Lowe
(kernels/hamming.py), then mono-essential RANSAC (5-point by default,
8-point with `use_5pt=False`) and 3d3d-Arun RANSAC (kernels/ransac.py) over
the whole chunk. Results for a candidate depend only on its structural
address (query robot/frame, target robot/frame) and the base key, never on
which chunk it is verified in.
"""

from __future__ import annotations

import torch

from ..core import backend, lie, rng as rngmod
from ..kernels import gather, hamming, ransac
from .dlc import FrontendConfig


def make_verifier(cfg: FrontendConfig, device="cuda"):
    """Builds `verify_many` for one configuration. It runs on the card
    unless the caller passes device="cpu"; asking for a card where there
    is none raises."""
    mono_fn = (ransac.ransac_essential_5pt if cfg.use_5pt
               else ransac.ransac_essential)
    dev = backend.resolve_device(device)

    def _index(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.long)

    @torch.no_grad()
    def verify_many(base_key, desc_store, obs_store, bear_store, lm_store,
                    qr, qf, tr, tm):
        """Verify C candidates (query robot qr / frame qf against target
        robot tr / frame tm, each (C,) integers).

        base_key: (2,) threefry key (core/rng.py). desc_store
        (R, T, K, 32) uint8, obs_store (R, T, K) bool, bear_store /
        lm_store (R, T, 3, K) f32 coordinate-major, all on `device`.
        Returns mono_ok, stereo_ok (C,) bool; mono_inliers,
        stereo_inliers (C,) int32; R (C, 3, 3), t (C, 3): the pose of the
        target frame expressed in the query frame."""
        for name, s in (("desc_store", desc_store), ("obs_store", obs_store),
                        ("bear_store", bear_store), ("lm_store", lm_store)):
            if s.device.type != dev.type:
                raise ValueError(f"{name} lies on {s.device}, the verifier "
                                 f"was made for {dev}")
        qr, qf, tr, tm = _index(qr), _index(qf), _index(tr), _index(tm)
        base_key = base_key.to(dev)
        dq, vq = desc_store[qr, qf], obs_store[qr, qf]
        dm, vm = desc_store[tr, tm], obs_store[tr, tm]
        m, _ = hamming.knn2_lowe_match_pairs(dq, vq, dm, vm,
                                             lowe_ratio=cfg.lowe_ratio)

        keys = rngmod.derive(base_key, qr, qf, tr, tm)  # (C, 2)
        matched = m >= 0
        idx = torch.clamp(m, min=0)
        bq, lq = bear_store[qr, qf], lm_store[qr, qf]
        bm_m = gather.permute_cols(bear_store[tr, tm], idx)
        lm_m = gather.permute_cols(lm_store[tr, tm], idx)
        kmono = rngmod.derive(keys, rngmod.Stream.RANSAC_MONO)
        mono = mono_fn(
            kmono, bq, bm_m, matched,
            threshold=cfg.mono_threshold, n_hyp=cfg.ransac_hyp,
            min_inliers=cfg.min_mono_inliers)
        kst = rngmod.derive(keys, rngmod.Stream.RANSAC_STEREO)
        st = ransac.ransac_arun(
            kst, lq, lm_m, matched,
            threshold=cfg.stereo_threshold, n_hyp=cfg.ransac_hyp,
            min_inliers=cfg.min_stereo_inliers)
        R_qm, t_qm = lie.se3_inverse(st["R"], st["t"])
        return {"mono_ok": mono["ok"], "stereo_ok": st["ok"],
                "mono_inliers": mono["n_inliers"],
                "stereo_inliers": st["n_inliers"],
                "R": R_qm, "t": t_qm}

    return verify_many
