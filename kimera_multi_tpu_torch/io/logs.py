"""Reference-schema log writers/readers (a copy of the JAX package's
io/logs.py, which is numpy only; the port keeps its own).

The on-disk output contract is how equivalence with the reference is judged
(SURVEY.md section 5 "Metrics / logging"): every format below byte-matches a
file the reference emits under $LOG_DIR/<robot>/.

  * TUM trajectories: `timestamp x y z qx qy qz qw`
    (distributed/kimera_distributed_poses_tum_<k>.tum, single/traj_pgo.tum;
    evo_real_time.py:90-97)
  * distributed/loop_closures.csv:
    robot1,pose1,robot2,pose2,qx,qy,qz,qw,tx,ty,tz,norm_bow_score,
    mono_inliers,stereo_inliers,stamp_ns  (lc_result.py:121-138)
  * distributed/kimera_distributed_keyframes.csv:
    keyframe_id,keyframe_stamp_ns,tx,ty,tz,qx,qy,qz,qw (lc_result.py:612-617)
  * single/output_lcd_status.csv:
    lcd_status,query_id,match_id,mono_inliers,stereo_inliers
    (lc_result.py:143-155)
  * single/output_lcd_result.csv: isLoop,queryKfId,matchKfId,
    timestamp_query,timestamp_match,x,y,z,qx,qy,qz,qw (lc_result.py:165-182)
  * distributed/dpgo_log_<k>.csv: per-iteration optimizer log
    (kimera-multi.drawio:2086,2136-2142)
"""

from __future__ import annotations

import os

import numpy as np


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


def write_tum(path: str, timestamps, t, q) -> None:
    """timestamps (N,) seconds; t (N, 3); q (N, 4) as (qx, qy, qz, qw)."""
    _ensure_dir(path)
    ts = np.asarray(timestamps, np.float64)
    t = np.asarray(t, np.float64)
    q = np.asarray(q, np.float64)
    with open(path, "w") as f:
        for i in range(len(ts)):
            f.write(
                f"{ts[i]:.9f} {t[i,0]:.9f} {t[i,1]:.9f} {t[i,2]:.9f} "
                f"{q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f}\n"
            )


def read_tum(path: str):
    """Returns (timestamps (N,), t (N, 3), q (N, 4) qx qy qz qw). Skips
    comment lines (# ...), matching evo's reader."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows, np.float64)
    if arr.size == 0:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


LOOP_CLOSURES_HEADER = (
    "robot1,pose1,robot2,pose2,qx,qy,qz,qw,tx,ty,tz,norm_bow_score,"
    "mono_inliers,stereo_inliers,stamp_ns"
)


def write_loop_closures_csv(path: str, rows) -> None:
    """rows: iterable of dicts with keys matching LOOP_CLOSURES_HEADER
    columns (robot1, pose1, robot2, pose2, qx..qw, tx..tz, norm_bow_score,
    mono_inliers, stereo_inliers, stamp_ns)."""
    _ensure_dir(path)
    cols = LOOP_CLOSURES_HEADER.split(",")
    with open(path, "w") as f:
        f.write(LOOP_CLOSURES_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r[c]) for c in cols) + "\n")


KEYFRAMES_HEADER = "keyframe_id,keyframe_stamp_ns,tx,ty,tz,qx,qy,qz,qw"


def write_keyframes_csv(path: str, rows) -> None:
    _ensure_dir(path)
    cols = KEYFRAMES_HEADER.split(",")
    with open(path, "w") as f:
        f.write(KEYFRAMES_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r[c]) for c in cols) + "\n")


LCD_STATUS_HEADER = "lcd_status,query_id,match_id,mono_inliers,stereo_inliers"


def write_lcd_status_csv(path: str, rows) -> None:
    _ensure_dir(path)
    cols = LCD_STATUS_HEADER.split(",")
    with open(path, "w") as f:
        f.write(LCD_STATUS_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r[c]) for c in cols) + "\n")


LCD_RESULT_HEADER = (
    "isLoop,queryKfId,matchKfId,timestamp_query,timestamp_match,"
    "x,y,z,qx,qy,qz,qw"
)


def write_lcd_result_csv(path: str, rows) -> None:
    _ensure_dir(path)
    cols = LCD_RESULT_HEADER.split(",")
    with open(path, "w") as f:
        f.write(LCD_RESULT_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r[c]) for c in cols) + "\n")


LCD_ATTEMPTS_HEADER = (
    "robot_a,frame_a,robot_b,frame_b,lcd_status,mono_inliers,"
    "stereo_inliers,norm_bow_score"
)


def write_lcd_attempts_csv(path: str, rows) -> None:
    """Full-fidelity attempt log (framework extension, not a reference
    format): the reference's output_lcd_status.csv has no target-robot
    column, so inter-robot rejected attempts cannot be replayed exactly
    from the reference schema alone. This sidecar carries the complete
    candidate identity for bit-exact replay (io/replay.py prefers it and
    falls back to the reference join when absent)."""
    _ensure_dir(path)
    cols = LCD_ATTEMPTS_HEADER.split(",")
    with open(path, "w") as f:
        f.write(LCD_ATTEMPTS_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r[c]) for c in cols) + "\n")


DPGO_LOG_HEADER = (
    "robot_id,instance,iteration,num_poses,bytes_received,"
    "iteration_time_sec,total_time_sec,rel_change,func_decrease,"
    "grad_norm,num_active_robots"
)


def write_dpgo_log_csv(path: str, rows) -> None:
    """Per-iteration optimizer log (role of dpgo_ros `logIteration`,
    drawio:2086)."""
    _ensure_dir(path)
    cols = DPGO_LOG_HEADER.split(",")
    with open(path, "w") as f:
        f.write(DPGO_LOG_HEADER + "\n")
        for r in rows:
            f.write(",".join(_fmt(r.get(c, 0)) for c in cols) + "\n")


def _fmt(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "1" if v else "0"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(v)
    return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)


def read_csv(path: str):
    """Minimal CSV reader returning a dict of numpy columns (floats where
    possible)."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f if line.strip()]
    cols = {}
    for j, name in enumerate(header):
        vals = [r[j] for r in rows]
        try:
            cols[name] = np.asarray([float(v) for v in vals])
        except ValueError:
            cols[name] = np.asarray(vals)
    return cols
