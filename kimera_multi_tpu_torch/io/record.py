"""Rendered sequences written as recorded sessions: an EuRoC ASL tree (PGM
or PNG frames) or a rosbag1 file, so that the recorded-data path (`cli/run.py
--mode euroc`, `io/convert.py`) runs without a downloaded dataset.

A window of frames [first, first + n) of an `io/render.RenderedSequence`
becomes one session:

  * frames: the left (and right) images times a fixed GAIN, clipped to
    8 bits (a fixed gain keeps brightness constant from frame to frame, as
    KLT needs), as `<ns>.pgm` (P5), `<ns>.png` (`io/png.write_png`) or
    sensor_msgs/Image mono8;
  * intrinsics (fu, fv, cu, cv) and the stereo baseline: cam0/cam1
    sensor.yaml (T_BS translation on x) or CameraInfo (K, P[0, 3] = -fx b);
  * IMU: the samples after the frame before the window up to its last
    frame (a recording's IMU starts a little before its first frame);
  * ground truth at every frame: position and the true attitude's
    quaternion (EuRoC's qw, qx, qy, qz in the ASL tree; nav_msgs/Odometry
    in a bag).

Numbers are written as their float32 values print (the form
`io/rosbag.rosbag_to_asl` writes), so an ASL tree and a bag written from
the same window read back to the same session.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import lie
from . import png, rosbag

GAIN = 120.0  # rendered sprite images are O(1) floats


def _window(seq, first: int, n: int | None):
    n = len(seq.timestamps) - first if n is None else n
    last = first + n - 1
    lo = seq.timestamps[first - 1] if first > 0 else -np.inf
    imu = np.nonzero((seq.imu_ts > lo)
                     & (seq.imu_ts <= seq.timestamps[last]))[0]
    return range(first, first + n), imu


def _to_u8(img) -> np.ndarray:
    return np.clip(np.asarray(img) * GAIN, 0, 255).astype(np.uint8)


def _quat_xyzw(R: np.ndarray) -> np.ndarray:
    return lie.rot_to_quat(torch.from_numpy(
        np.asarray(R, np.float32))).numpy()


def _ns(t: float) -> int:
    return int(t * 1e9)


def _sensor_yaml(path: str, intrinsics, tx: float) -> None:
    fu, fv, cu, cv = (np.float32(x) for x in intrinsics)
    with open(path, "w") as f:
        f.write("sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n"
                f"  data: [1.0, 0.0, 0.0, {tx},\n"
                "         0.0, 1.0, 0.0, 0.0,\n"
                "         0.0, 0.0, 1.0, 0.0,\n"
                "         0.0, 0.0, 0.0, 1.0]\n"
                f"intrinsics: [{fu}, {fv}, {cu}, {cv}]\n")


def write_asl_session(root: str, seq, intrinsics, baseline: float,
                      first: int = 0, n: int | None = None,
                      image_format: str = "pgm", stereo: bool = True,
                      with_gt: bool = True) -> str:
    """Frames [first, first + n) of `seq` as an EuRoC ASL tree under
    `root` (mav0/cam0, cam1 when `stereo`, imu0,
    state_groundtruth_estimate0 when `with_gt`); images as "pgm" or "png".
    Returns root."""
    if image_format not in ("pgm", "png"):
        raise ValueError(f"image_format is pgm or png, not {image_format}")
    frames, imu = _window(seq, first, n)
    mav = os.path.join(root, "mav0")
    cams = [("cam0", seq.left, 0.0)]
    if stereo:
        cams.append(("cam1", seq.right, baseline))
    for cam, images, tx in cams:
        ddir = os.path.join(mav, cam, "data")
        os.makedirs(ddir, exist_ok=True)
        rows = []
        for k in frames:
            ns = _ns(seq.timestamps[k])
            name = f"{ns}.{image_format}"
            a = _to_u8(images[k])
            if image_format == "png":
                png.write_png(os.path.join(ddir, name), a)
            else:
                with open(os.path.join(ddir, name), "wb") as f:
                    f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
                    f.write(a.tobytes())
            rows.append(f"{ns},{name}")
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
        _sensor_yaml(os.path.join(mav, cam, "sensor.yaml"), intrinsics, tx)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in imu:
            g, a = seq.gyro[i], seq.accel[i]
            f.write(f"{_ns(seq.imu_ts[i])},{g[0]},{g[1]},{g[2]},"
                    f"{a[0]},{a[1]},{a[2]}\n")
    if with_gt:
        gdir = os.path.join(mav, "state_groundtruth_estimate0")
        os.makedirs(gdir, exist_ok=True)
        q = _quat_xyzw(seq.R_gt)
        with open(os.path.join(gdir, "data.csv"), "w") as f:
            f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
            for k in frames:
                t = seq.t_gt[k]
                f.write(f"{_ns(seq.timestamps[k])},{t[0]},{t[1]},{t[2]},"
                        f"{q[k, 3]},{q[k, 0]},{q[k, 1]},{q[k, 2]}\n")
    return root


def write_bag_session(path: str, seq, intrinsics, baseline: float,
                      first: int = 0, n: int | None = None,
                      stereo: bool = True, with_gt: bool = True) -> str:
    """Frames [first, first + n) of `seq` as a rosbag1 file (one
    uncompressed chunk, `io/rosbag.BagWriter`): /cam0/image_raw (and
    /cam1/image_raw when `stereo`) mono8 with a CameraInfo beside each,
    /imu0, and /odometry ground truth when `with_gt`. Returns path."""
    frames, imu = _window(seq, first, n)
    fu, fv, cu, cv = intrinsics
    h, w = seq.left.shape[1:]
    q = _quat_xyzw(seq.R_gt)
    bw = rosbag.BagWriter(path)
    cams = [("/cam0", seq.left, 0.0)]
    if stereo:
        cams.append(("/cam1", seq.right, baseline))
    ns0 = _ns(seq.timestamps[frames[0]])
    for topic, _, b in cams:
        bw.write(f"{topic}/camera_info", "sensor_msgs/CameraInfo", ns0,
                 rosbag.BagWriter.ser_camera_info(ns0, w, h, fu, fv, cu, cv,
                                                  baseline=b))
    for k in frames:
        ns = _ns(seq.timestamps[k])
        for topic, images, _ in cams:
            bw.write(f"{topic}/image_raw", "sensor_msgs/Image", ns,
                     rosbag.BagWriter.ser_image(ns, _to_u8(images[k])))
        if with_gt:
            bw.write("/odometry", "nav_msgs/Odometry", ns,
                     rosbag.BagWriter.ser_odometry(ns, seq.t_gt[k], q[k]))
    for i in imu:
        ns = _ns(seq.imu_ts[i])
        bw.write("/imu0", "sensor_msgs/Imu", ns,
                 rosbag.BagWriter.ser_imu(ns, seq.gyro[i], seq.accel[i]))
    bw.close()
    return path
