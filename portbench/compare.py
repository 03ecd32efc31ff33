"""The comparison that decides `correct`: the program's answers for a
sample of candidates, drawn from the seed, in every pass of the window,
against the plain reference's answers for the same candidates.

Numbers compared (each against the limit in `limits/<workload>.json`):

  match_entries_differing  entries of the 2-NN + Lowe match table (from
                           the window's last pass) that differ
  mono_gate_differing      candidates whose mono `ok` differs in any pass
  stereo_gate_differing    candidates whose stereo `ok` differs in any pass
  stereo_inliers_gap       widest |n - n_ref| / max(n, n_ref) over the
                           results where either side reaches the gate's
                           minimum
  rotation_gap_rad         widest angle between R and R_ref where both
                           stereo gates pass
  translation_gap_m        widest |t - t_ref| there

The mono inlier counts are reported beside them and not compared
(`REPORTED`): at the 1e-6 squared-Sampson threshold and the world's
landmark noise the count of the re-solved model moves by up to a fifth
with any change of the winning hypothesis, float32 against float64 as
much as TF32 against float64, so no limit separates a sound program from
the control (PERF.md, section 2). The mono gate they decide is compared.
"""

from __future__ import annotations

import numpy as np

NAMES = ("match_entries_differing", "mono_gate_differing",
         "stereo_gate_differing", "stereo_inliers_gap", "rotation_gap_rad",
         "translation_gap_m")
REPORTED = ("mono_inliers_gap", "mono_inliers_sum_gap")


def sample(n: int, size: int, seed: int) -> np.ndarray:
    """The candidates compared in a run: `size` distinct indices into the
    backlog, drawn from the seed."""
    npr = np.random.default_rng([seed, 2])
    return np.sort(npr.choice(n, size=min(size, n), replace=False))


def _gaps(n, n_ref, floor):
    """(widest relative gap, relative gap of the sums) over the entries
    where either count reaches `floor`."""
    n, n_ref = n.astype(np.float64), n_ref.astype(np.float64)
    use = np.maximum(n, n_ref) >= floor
    if not use.any():
        return 0.0, 0.0
    n, n_ref = n[use], n_ref[use]
    return (float(np.max(np.abs(n - n_ref) / np.maximum(n, n_ref))),
            float(abs(n.sum() - n_ref.sum()) / n_ref.sum())
            if n_ref.sum() > 0 else float("inf"))


def _angle(R, R_ref):
    """Angle between rotations from ||R - R_ref||_F = 2 sqrt(2) sin(a / 2),
    which keeps its digits near 0 where arccos of the trace does not."""
    d = np.linalg.norm((R.astype(np.float64) - R_ref).reshape(
        len(R), -1), axis=-1)
    return 2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def numbers(prog: dict, ref: dict, cfg: dict) -> dict:
    """prog: per-pass answers (P, S, ...) for the S sampled candidates and
    the match table (S, K) of the last pass; ref: the reference's (S, ...)
    answers. Returns the numbers compared."""
    out = {"match_entries_differing": int(
        np.sum(prog["match"] != ref["match"]))}
    for gate in ("mono", "stereo"):
        ok = prog[f"{gate}_ok"] != ref[f"{gate}_ok"][None]
        out[f"{gate}_gate_differing"] = int(np.sum(ok.any(0)))
    P = prog["mono_ok"].shape[0]

    def rep(x):
        return np.broadcast_to(x[None], (P,) + x.shape).reshape(
            -1, *x.shape[1:])

    out["mono_inliers_gap"], out["mono_inliers_sum_gap"] = _gaps(
        prog["mono_inliers"].reshape(-1), rep(ref["mono_inliers"]),
        cfg["min_mono_inliers"])
    out["stereo_inliers_gap"], _ = _gaps(
        prog["stereo_inliers"].reshape(-1), rep(ref["stereo_inliers"]),
        cfg["min_stereo_inliers"])
    both = (prog["stereo_ok"] & ref["stereo_ok"][None]).reshape(-1)
    R, R_ref = prog["R"].reshape(-1, 3, 3), rep(ref["R"])
    t, t_ref = prog["t"].reshape(-1, 3), rep(ref["t"])
    if both.any():
        out["rotation_gap_rad"] = float(np.max(_angle(R[both],
                                                      R_ref[both])))
        out["translation_gap_m"] = float(np.max(np.linalg.norm(
            t[both].astype(np.float64) - t_ref[both], axis=-1)))
    else:
        out["rotation_gap_rad"] = out["translation_gap_m"] = 0.0
    for k in ("rotation_gap_rad", "translation_gap_m"):
        if not np.isfinite(out[k]):
            out[k] = float("inf")
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """correct, and [name, number, limit] for every number compared."""
    rows = [[k, nums[k], limits[k]] for k in NAMES]
    return all(v <= lim for _, v, lim in rows), rows
