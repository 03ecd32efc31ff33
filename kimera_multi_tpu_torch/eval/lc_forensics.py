"""Loop-closure forensics (the JAX package's eval/lc_forensics.py: the
reference's evaluation/lc_result.py, analyze_inliers.py and
extract_lc_images.py).

Cross-checks every logged loop closure against ground truth: the
ground-truth relative pose of the pair against the estimated transform,
the ground-truth distance between the matched keyframes, inter / intra
classification, and the inlier counts against the mono = 10 / stereo = 5
acceptance boundary (buckets 0 - 10 / 10 - 30 / > 30 m; loops over 30 m
are suspicious). The 3 x 3 work is small and stays on the host, in torch
float32 (as the JAX package does it in jnp).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..io import logs, png


class LcForensics(NamedTuple):
    n_total: int
    n_inter: int
    n_intra: int
    rot_err_deg: np.ndarray  # (N,) estimated vs ground-truth rotation
    trans_err: np.ndarray  # (N,)
    gt_distance: np.ndarray  # (N,) distance of the matched GT positions
    mono_inliers: np.ndarray
    stereo_inliers: np.ndarray
    suspicious: np.ndarray  # (N,) bool: GT distance > 30 m
    rows: tuple = ()  # per-loop dicts (ids + metrics) for evidence tools


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def analyze_run(log_dir: str, gt_tum: dict, n_robots: int,
                out_csv: str | None = None) -> LcForensics:
    """Join each robot's loop_closures.csv against ground-truth TUM
    trajectories (gt_tum: robot id -> path); a keyframe's pose is the
    trajectory's row at the keyframe's index."""
    gt = {}
    for r, path in gt_tum.items():
        ts, t, q = logs.read_tum(path)
        gt[r] = (ts, t, lie.quat_to_rot(_f32(q)).numpy())

    rows = []
    for r in range(n_robots):
        lc_path = os.path.join(log_dir, f"robot{r}", "distributed",
                               "loop_closures.csv")
        if not os.path.exists(lc_path):
            continue
        lc = logs.read_csv(lc_path)
        col = lambda c: np.atleast_1d(lc[c])  # noqa: E731
        if len(np.atleast_1d(lc.get("robot1", []))) == 0:
            continue
        for i in range(len(col("robot1"))):
            r1, p1 = int(col("robot1")[i]), int(col("pose1")[i])
            r2, p2 = int(col("robot2")[i]), int(col("pose2")[i])
            if r1 not in gt or r2 not in gt:
                continue
            ts1, t1, R1 = gt[r1]
            ts2, t2, R2 = gt[r2]
            if p1 >= len(ts1) or p2 >= len(ts2):
                continue
            # ground-truth pose of keyframe p2 (robot2) in keyframe p1's
            Rg, tg = lie.se3_between(_f32(R1[p1]), _f32(t1[p1]),
                                     _f32(R2[p2]), _f32(t2[p2]))
            q = np.asarray([col(c)[i] for c in ("qx", "qy", "qz", "qw")])
            te = np.asarray([col(c)[i] for c in ("tx", "ty", "tz")])
            Re = lie.quat_to_rot(_f32(q))
            rot_err = float(np.degrees(
                lie.rotation_geodesic_distance(Re, Rg).numpy()))
            rows.append(dict(
                robot1=r1, pose1=p1, robot2=r2, pose2=p2,
                inter=int(r1 != r2), rot_err_deg=rot_err,
                trans_err=float(np.linalg.norm(te - tg.numpy())),
                gt_distance=float(np.linalg.norm(t1[p1] - t2[p2])),
                mono_inliers=int(col("mono_inliers")[i]),
                stereo_inliers=int(col("stereo_inliers")[i])))

    if out_csv and rows:
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        cols = list(rows[0].keys())
        with open(out_csv, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in rows:
                f.write(",".join(str(row[c]) for c in cols) + "\n")

    if not rows:
        z = np.zeros(0)
        return LcForensics(0, 0, 0, z, z, z, z, z, z.astype(bool))
    a = {k: np.asarray([row[k] for row in rows]) for k in rows[0]}
    return LcForensics(
        n_total=len(rows), n_inter=int(a["inter"].sum()),
        n_intra=int((1 - a["inter"]).sum()), rot_err_deg=a["rot_err_deg"],
        trans_err=a["trans_err"], gt_distance=a["gt_distance"],
        mono_inliers=a["mono_inliers"], stereo_inliers=a["stereo_inliers"],
        suspicious=a["gt_distance"] > 30.0, rows=tuple(rows))


def _to_u8(im) -> np.ndarray:
    """A frame as uint8: uint8 as it is, anything else stretched from its
    minimum to its maximum."""
    im = im.detach().cpu().numpy() if torch.is_tensor(im) else np.asarray(im)
    if im.dtype != np.uint8:
        lo, hi = float(im.min()), float(im.max())
        im = ((im - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    return im


def extract_lc_images(rows, image_of, out_dir: str,
                      threshold: float = 30.0) -> list:
    """Image evidence for suspicious loop closures: for every row whose
    ground-truth keyframe distance exceeds `threshold`, the two keyframe
    images side by side under a caption (pair ids, distance, inlier
    counts), one PNG a loop, and lc_images.json listing them.

    rows: dicts with robot1 / pose1 / robot2 / pose2 / gt_distance /
    mono_inliers / stereo_inliers (LcForensics.rows); image_of(robot,
    frame) -> an (H, W) uint8 or float image, or None. Returns the paths
    written."""
    os.makedirs(out_dir, exist_ok=True)
    written, manifest = [], []
    for i, row in enumerate(rows):
        d = float(row["gt_distance"])
        if d <= threshold:
            continue
        r1, p1 = int(row["robot1"]), int(row["pose1"])
        r2, p2 = int(row["robot2"]), int(row["pose2"])
        im1, im2 = image_of(r1, p1), image_of(r2, p2)
        if im1 is None or im2 is None:
            continue
        cap = (f"r{r1}f{p1}-r{r2}f{p2} d:{d:.1f}m "
               f"mono:{int(row['mono_inliers'])} "
               f"stereo:{int(row['stereo_inliers'])}")
        img = png.annotate_pair(_to_u8(im1), _to_u8(im2), cap)
        name = f"lc_{i:04d}_r{r1}f{p1}_r{r2}f{p2}_{d:.1f}m.png"
        path = os.path.join(out_dir, name)
        png.write_png(path, img)
        written.append(path)
        manifest.append({**{k: (float(v) if isinstance(v, np.floating)
                                else int(v) if isinstance(v, np.integer)
                                else v) for k, v in row.items()},
                         "image": name})
    with open(os.path.join(out_dir, "lc_images.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return written


def inlier_histogram(res: LcForensics) -> dict:
    """Inlier-count statistics per ground-truth distance bucket (0 - 10 /
    10 - 30 / > 30 m)."""
    out = {}
    for lo, hi in [(0, 10), (10, 30), (30, np.inf)]:
        m = (res.gt_distance >= lo) & (res.gt_distance < hi)
        out[f"{lo}-{hi}"] = dict(
            count=int(m.sum()),
            mono_mean=float(res.mono_inliers[m].mean()) if m.any() else 0.0,
            stereo_mean=(float(res.stereo_inliers[m].mean()) if m.any()
                         else 0.0),
            mono_below_10=int((res.mono_inliers[m] < 10).sum()),
            stereo_below_5=int((res.stereo_inliers[m] < 5).sum()))
    return out
