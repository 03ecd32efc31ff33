"""Replay-acceptance harness: re-run verification on recorded candidates
(the JAX package's io/replay.py).

The acceptance compares a run against reference runs by (a) status and
inlier-count equality on every attempted loop-closure candidate and (b)
APE of the TUM trajectories. This module performs (a): it reads a run's
reference-schema logs (`distributed/loop_closures.csv`,
`single/output_lcd_status.csv`, or the `distributed/lcd_attempts.csv`
sidecar) plus recorded per-keyframe observation streams, re-runs the
port's batched verifier (`frontend/batched.make_verifier`) on every
recorded candidate, and diffs statuses and inlier counts row by row;
`replay_ape` performs (b) on the port's `eval/ape.py`.

Observation streams are one `.npz` per robot (`obs_robot<k>.npz`:
descriptors (T, K, 32) uint8, bearings (T, K, 3) f32, landmarks (T, K, 3)
f32, valid (T, K) bool, timestamps (T,) f64), written by `cli/run.py
--save-obs` and by `io/convert.py` from recordings. The stream I/O is a
copy of the JAX package's (numpy only), so either package reads what the
other writes.

Replaying logs the port produced on the same seed reproduces statuses and
inlier counts bit for bit: a candidate's RANSAC keys derive from its
structural address (query robot, frame, target robot, frame) and the base
key, and nothing on the verification path reduces across candidates, so
its result does not depend on the batch it is verified in.
"""

from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import backend, lie, rng as rngmod
from ..core.containers import (
    LCD_FAILED_GEOM_VERIFICATION,
    LCD_FAILED_POSE_RECOVERY,
    LCD_LOOP_DETECTED,
    LCD_STATUS_NAMES,
)
from . import logs


class ObservationStream(NamedTuple):
    """Per-robot recorded keyframe observations (the VLC-frame stream)."""

    descriptors: np.ndarray  # (T, K, 32) uint8 packed ORB
    bearings: np.ndarray  # (T, K, 3) f32 unit bearings (camera frame)
    landmarks: np.ndarray  # (T, K, 3) f32 3d points (camera frame)
    valid: np.ndarray  # (T, K) bool
    timestamps: np.ndarray  # (T,) f64 seconds


def save_observations(path: str, s: ObservationStream) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, descriptors=s.descriptors, bearings=s.bearings,
        landmarks=s.landmarks, valid=s.valid, timestamps=s.timestamps)


def load_observations(path: str) -> ObservationStream:
    z = np.load(path)
    return ObservationStream(
        descriptors=z["descriptors"], bearings=z["bearings"],
        landmarks=z["landmarks"], valid=z["valid"],
        timestamps=z["timestamps"])


def obs_path(obs_dir: str, robot: int) -> str:
    return os.path.join(obs_dir, f"obs_robot{robot}.npz")


class RecordedCandidate(NamedTuple):
    robot_a: int
    frame_a: int
    robot_b: int
    frame_b: int
    mono_inliers: int
    stereo_inliers: int
    status: int  # LCD_* code
    R: np.ndarray | None  # recorded T^a_b (None if not in the log)
    t: np.ndarray | None


_STATUS_CODES = {v: k for k, v in LCD_STATUS_NAMES.items()}


def _rows(table: dict, first: str):
    """Row getters of a `logs.read_csv` table (columns may be scalars)."""
    n = len(np.atleast_1d(table.get(first, [])))
    for i in range(n):
        yield lambda c, i=i: np.atleast_1d(table[c])[i]


def _pose(g):
    """(R, t) of a loop_closures.csv row, R from its quaternion."""
    q = np.asarray([g("qx"), g("qy"), g("qz"), g("qw")], np.float32)
    R = lie.quat_to_rot(torch.from_numpy(q)).numpy()
    return R, np.asarray([g("tx"), g("ty"), g("tz")], np.float32)


def read_recorded_candidates(log_dir: str, n_robots: int
                             ) -> list[RecordedCandidate]:
    """Collect every recorded verification attempt of a run.

    * `distributed/loop_closures.csv` rows are accepted candidates
      (status LOOP_DETECTED) with the recorded relative pose.
    * `single/output_lcd_status.csv` rows carry the full status taxonomy.
      The reference schema has no robot columns (it is written per robot
      directory); rows not already present as a loop-closure row are
      joined as same-robot attempts.
    * When every robot directory carries the `distributed/lcd_attempts.csv`
      sidecar (`logs.write_lcd_attempts_csv`), it is read instead: it pins
      the target robot of rejected inter-robot attempts, which the
      reference schema cannot express.
    """
    def lc_path(r):
        return os.path.join(log_dir, f"robot{r}", "distributed",
                            "loop_closures.csv")

    sidecars = [os.path.join(log_dir, f"robot{r}", "distributed",
                             "lcd_attempts.csv") for r in range(n_robots)]
    if all(os.path.exists(p) for p in sidecars):
        lc_pose: dict[tuple[int, int, int, int], tuple] = {}
        for r in range(n_robots):
            if not os.path.exists(lc_path(r)):
                continue
            for g in _rows(logs.read_csv(lc_path(r)), "robot1"):
                key = (int(g("robot1")), int(g("pose1")),
                       int(g("robot2")), int(g("pose2")))
                lc_pose[key] = _pose(g)
        out: list[RecordedCandidate] = []
        for p in sidecars:
            for g in _rows(logs.read_csv(p), "robot_a"):
                key = (int(g("robot_a")), int(g("frame_a")),
                       int(g("robot_b")), int(g("frame_b")))
                R, t = lc_pose.get(key, (None, None))
                out.append(RecordedCandidate(
                    robot_a=key[0], frame_a=key[1], robot_b=key[2],
                    frame_b=key[3],
                    mono_inliers=int(g("mono_inliers")),
                    stereo_inliers=int(g("stereo_inliers")),
                    status=_STATUS_CODES.get(str(g("lcd_status")), -1),
                    R=R, t=t))
        return out

    cands: list[RecordedCandidate] = []
    seen: set[tuple[int, int, int]] = set()  # (robot_a, frame_a, frame_b)
    for r in range(n_robots):
        if not os.path.exists(lc_path(r)):
            continue
        for g in _rows(logs.read_csv(lc_path(r)), "robot1"):
            R, t = _pose(g)
            cands.append(RecordedCandidate(
                robot_a=int(g("robot1")), frame_a=int(g("pose1")),
                robot_b=int(g("robot2")), frame_b=int(g("pose2")),
                mono_inliers=int(g("mono_inliers")),
                stereo_inliers=int(g("stereo_inliers")),
                status=LCD_LOOP_DETECTED, R=R, t=t))
            seen.add((int(g("robot1")), int(g("pose1")), int(g("pose2"))))
    for r in range(n_robots):
        st_path = os.path.join(log_dir, f"robot{r}", "single",
                               "output_lcd_status.csv")
        if not os.path.exists(st_path):
            continue
        for g in _rows(logs.read_csv(st_path), "lcd_status"):
            code = _STATUS_CODES.get(str(g("lcd_status")), -1)
            qa, qb = int(g("query_id")), int(g("match_id"))
            if code == LCD_LOOP_DETECTED and (r, qa, qb) in seen:
                continue  # already joined from loop_closures.csv
            cands.append(RecordedCandidate(
                robot_a=r, frame_a=qa, robot_b=r, frame_b=qb,
                mono_inliers=int(g("mono_inliers")),
                stereo_inliers=int(g("stereo_inliers")),
                status=code, R=None, t=None))
    return cands


# candidates a verifier call takes (BatchedFrontend's default chunk)
VERIFY_CHUNK = 1024


class ReplayReport(NamedTuple):
    n_candidates: int
    n_status_match: int
    n_mono_exact: int
    n_stereo_exact: int
    n_mono_within_tol: int
    n_stereo_within_tol: int
    max_mono_delta: int
    max_stereo_delta: int
    max_trans_delta: float  # vs recorded accepted poses
    rows: list[dict]


def load_stores(obs_dir: str, n_robots: int, device):
    """The robots' observation streams as the verifier's keyframe stores
    on `device`: desc (R, T, K, 32) uint8, valid (R, T, K) bool, bearings
    and landmarks (R, T, 3, K) f32 coordinate-major, zero-padded to the
    longest stream."""
    streams = [load_observations(obs_path(obs_dir, r))
               for r in range(n_robots)]
    T = max(s.descriptors.shape[0] for s in streams)
    K = max(s.descriptors.shape[1] for s in streams)
    R = n_robots
    desc = np.zeros((R, T, K, 32), np.uint8)
    bear = np.zeros((R, T, K, 3), np.float32)
    lm = np.zeros((R, T, K, 3), np.float32)
    val = np.zeros((R, T, K), bool)
    for r, s in enumerate(streams):
        t, k = s.descriptors.shape[:2]
        desc[r, :t, :k] = s.descriptors
        bear[r, :t, :k] = s.bearings
        lm[r, :t, :k] = s.landmarks
        val[r, :t, :k] = s.valid
    soa = lambda a: torch.from_numpy(a).to(device).transpose(
        -1, -2).contiguous()
    return (torch.from_numpy(desc).to(device),
            torch.from_numpy(val).to(device), soa(bear), soa(lm))


def replay_verify(log_dir: str, obs_dir: str, n_robots: int, cfg=None,
                  inlier_tol: int = 0, out_csv: str | None = None,
                  device="cuda") -> ReplayReport:
    """Re-run the verifier on every recorded candidate and diff row by row,
    on `device` (the card unless told otherwise).

    inlier_tol: allowed |recorded - replayed| inlier slack counted as
    "within tolerance" (0 = demand bit-equality, the own-logs case).
    The candidates, in log order, are zero-padded to the next power of two
    (as the JAX package does) and verified in pieces of at most
    VERIFY_CHUNK (as `BatchedFrontend.verify_candidates` does), which
    bounds memory and changes no result."""
    from ..frontend import batched as batched_mod
    from ..frontend.dlc import FrontendConfig

    cfg = cfg or FrontendConfig()
    dev = backend.resolve_device(device)
    cands = read_recorded_candidates(log_dir, n_robots)
    stores = load_stores(obs_dir, n_robots, dev)
    B = len(cands)
    if B == 0:
        return ReplayReport(0, 0, 0, 0, 0, 0, 0, 0, 0.0, [])
    verify = batched_mod.make_verifier(cfg, device=dev)
    Bp = max(1, int(2 ** np.ceil(np.log2(B))))
    pad = [0] * (Bp - B)
    idx = [np.asarray([getattr(c, f) for c in cands] + pad, np.int64)
           for f in ("robot_a", "frame_a", "robot_b", "frame_b")]
    key = rngmod.base_key(cfg.base_seed, device=dev)
    step = min(VERIFY_CHUNK, Bp)
    parts = [verify(key, *stores, *(a[lo:lo + step] for a in idx))
             for lo in range(0, Bp, step)]
    res = {k: torch.cat([p[k] for p in parts]).cpu().numpy()
           for k in parts[0]}

    rows = []
    n_status = n_me = n_se = n_mt = n_st = 0
    dmono = dstereo = 0
    dtrans = 0.0
    for i, c in enumerate(cands):
        if not res["mono_ok"][i]:
            status = LCD_FAILED_GEOM_VERIFICATION
        elif not res["stereo_ok"][i]:
            status = LCD_FAILED_POSE_RECOVERY
        else:
            status = LCD_LOOP_DETECTED
        mono = int(res["mono_inliers"][i])
        stereo = int(res["stereo_inliers"][i])
        dm, ds = abs(mono - c.mono_inliers), abs(stereo - c.stereo_inliers)
        td = (float(np.linalg.norm(res["t"][i] - c.t))
              if c.t is not None and status == LCD_LOOP_DETECTED else 0.0)
        n_status += int(status == c.status)
        n_me += int(dm == 0)
        n_se += int(ds == 0)
        n_mt += int(dm <= inlier_tol)
        n_st += int(ds <= inlier_tol)
        dmono, dstereo = max(dmono, dm), max(dstereo, ds)
        dtrans = max(dtrans, td)
        rows.append(dict(
            robot_a=c.robot_a, frame_a=c.frame_a, robot_b=c.robot_b,
            frame_b=c.frame_b,
            status_recorded=LCD_STATUS_NAMES.get(c.status, "UNKNOWN"),
            status_replayed=LCD_STATUS_NAMES.get(status, "UNKNOWN"),
            mono_recorded=c.mono_inliers, mono_replayed=mono,
            stereo_recorded=c.stereo_inliers, stereo_replayed=stereo,
            trans_delta=td))

    if out_csv:
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        cols = list(rows[0].keys())
        with open(out_csv, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in rows:
                f.write(",".join(str(row[c]) for c in cols) + "\n")

    return ReplayReport(
        n_candidates=B, n_status_match=n_status, n_mono_exact=n_me,
        n_stereo_exact=n_se, n_mono_within_tol=n_mt,
        n_stereo_within_tol=n_st, max_mono_delta=dmono,
        max_stereo_delta=dstereo, max_trans_delta=dtrans, rows=rows)


def replay_ape(log_dir: str, gt_tum: dict[int, str], n_robots: int,
               max_diff: float = 0.01, device="cuda") -> dict[int, dict]:
    """Trajectory acceptance: each robot's newest TUM dump against its
    ground-truth TUM (associated by timestamp within `max_diff`, aligned,
    APE: the evo_real_time.py contract), on `device`."""
    from ..eval import ape as ape_mod

    dev = backend.resolve_device(device)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    out = {}
    for r in range(n_robots):
        pattern = os.path.join(log_dir, f"robot{r}", "distributed",
                               "kimera_distributed_poses_tum_*.tum")
        files = sorted(glob.glob(pattern),
                       key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
        if not files or r not in gt_tum:
            continue
        ts, t, q = logs.read_tum(files[-1])
        gts, gt_t, gt_q = logs.read_tum(gt_tum[r])
        ii, jj = ape_mod.associate(ts, gts, max_diff=max_diff)
        res = ape_mod.ape(f32(t[ii]), lie.quat_to_rot(f32(q[ii])),
                          f32(gt_t[jj]), lie.quat_to_rot(f32(gt_q[jj])),
                          align=True)
        out[r] = dict(rmse_trans=res.rmse_trans, rmse_full=res.rmse_full,
                      n_matched=res.n_matched)
    return out
