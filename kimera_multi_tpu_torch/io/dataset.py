"""Dataset readers: EuRoC-format sessions (+ multi-session as
pseudo-multi-robot). A copy of the JAX package's io/dataset.py, which is
numpy only; the port keeps its own.

Role of the reference's data providers (RosbagDataProvider,
drawio:834-863) for environments without ROS: the EuRoC ASL layout
(mav0/cam0/data.csv, mav0/imu0/data.csv, mav0/state_groundtruth_estimate0)
is the standard public format; BASELINE.json config 4 uses "EuRoC
multi-session as pseudo-multi-robot".

As in the JAX package, only the first four `intrinsics` of a
sensor.yaml are read (fu, fv, cu, cv): the distortion coefficients are
ignored, so a distorted recording is tracked as if it were pinhole.
"""

from __future__ import annotations

import csv
import os
from typing import NamedTuple

import numpy as np


class EurocSession(NamedTuple):
    cam_ts: np.ndarray  # (F,) seconds
    cam_files: list  # (F,) image paths (cam0)
    imu_ts: np.ndarray  # (M,)
    gyro: np.ndarray  # (M, 3)
    accel: np.ndarray  # (M, 3)
    gt_ts: np.ndarray  # (G,) or empty
    gt_t: np.ndarray  # (G, 3)
    gt_q: np.ndarray  # (G, 4) qx qy qz qw
    cam1_files: tuple = ()  # (F,) right-camera paths when cam1 exists
    intrinsics: tuple | None = None  # (fu, fv, cu, cv) from sensor.yaml
    baseline: float = 0.0  # |t_cam1 - t_cam0| from the T_BS extrinsics


def _read_sensor_yaml(path: str):
    """Minimal EuRoC sensor.yaml parse (intrinsics + T_BS translation)
    without a YAML dependency — the fields used are single-line lists."""
    intr = None
    t_bs = None
    if not os.path.exists(path):
        return intr, t_bs
    txt = open(path).read()
    import re

    m = re.search(r"intrinsics:\s*\[([^\]]+)\]", txt)
    if m:
        vals = [float(x) for x in m.group(1).split(",")]
        if len(vals) >= 4:
            intr = tuple(vals[:4])
    m = re.search(r"data:\s*\[([^\]]+)\]", txt, re.S)
    if m:
        vals = [float(x) for x in m.group(1).replace("\n", " ").split(",")]
        if len(vals) == 16:  # row-major 4x4 T_BS
            t_bs = np.asarray([vals[3], vals[7], vals[11]], np.float32)
    return intr, t_bs


def load_euroc(root: str) -> EurocSession:
    """Load one EuRoC session directory (containing mav0/)."""
    mav = os.path.join(root, "mav0")
    cam_csv = os.path.join(mav, "cam0", "data.csv")
    cam_ts, cam_files = [], []
    if os.path.exists(cam_csv):
        with open(cam_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                cam_ts.append(int(row[0]) * 1e-9)
                cam_files.append(os.path.join(mav, "cam0", "data",
                                              row[1].strip()))
    cam1_files = []
    cam1_csv = os.path.join(mav, "cam1", "data.csv")
    if os.path.exists(cam1_csv):
        with open(cam1_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                cam1_files.append(os.path.join(mav, "cam1", "data",
                                               row[1].strip()))
    intr, t0 = _read_sensor_yaml(os.path.join(mav, "cam0", "sensor.yaml"))
    _, t1 = _read_sensor_yaml(os.path.join(mav, "cam1", "sensor.yaml"))
    baseline = (float(np.linalg.norm(t1 - t0))
                if t0 is not None and t1 is not None else 0.0)
    imu_csv = os.path.join(mav, "imu0", "data.csv")
    imu_ts, gyro, accel = [], [], []
    if os.path.exists(imu_csv):
        with open(imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                imu_ts.append(int(row[0]) * 1e-9)
                gyro.append([float(x) for x in row[1:4]])
                accel.append([float(x) for x in row[4:7]])
    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    gt_ts, gt_t, gt_q = [], [], []
    if os.path.exists(gt_csv):
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                gt_ts.append(int(row[0]) * 1e-9)
                gt_t.append([float(x) for x in row[1:4]])
                # EuRoC GT quaternions are (qw, qx, qy, qz) -> reorder
                qw, qx, qy, qz = (float(x) for x in row[4:8])
                gt_q.append([qx, qy, qz, qw])
    return EurocSession(
        cam_ts=np.asarray(cam_ts),
        cam_files=cam_files,
        imu_ts=np.asarray(imu_ts),
        gyro=np.asarray(gyro, np.float32).reshape(-1, 3),
        accel=np.asarray(accel, np.float32).reshape(-1, 3),
        gt_ts=np.asarray(gt_ts),
        gt_t=np.asarray(gt_t, np.float32).reshape(-1, 3),
        gt_q=np.asarray(gt_q, np.float32).reshape(-1, 4),
        cam1_files=tuple(cam1_files),
        intrinsics=intr,
        baseline=baseline,
    )


def load_multi_session(roots: list) -> list:
    """Multiple EuRoC sessions as pseudo-robots (BASELINE.json config 4)."""
    return [load_euroc(r) for r in roots]
