"""Recorded-data converter: EuRoC session trees (or rosbag1 files) ->
replay observation streams + GT TUM (the JAX package's io/convert.py).

One EuRoC session per robot (EuRoC multi-session as pseudo-multi-robot,
BASELINE.json config 4; the Kimera-Multi-Data releases ship the same ASL
layout) runs through the port's VIO pipeline (vio/pipeline.py) on the
card, or on the CPU when asked. Its keyframe products (packed
descriptors, unit bearings, stereo landmarks, validity, timestamps) are
written as `obs_robot<k>.npz`, the format `cli/replay.py` reads, and the
session's ground truth (when it has state_groundtruth_estimate0) as a TUM
file.

    python -m kimera_multi_tpu_torch.io.convert --euroc SESSION \
        [--bag FILE.bag] --out DIR [--max-frames N] [--device cpu]

Images are read without PIL: binary and ASCII PGM, `.npy`, and 8-bit PNG
(grayscale, EuRoC's, or RGB, reduced to grayscale by PIL's integer rule)
decoded here: zlib, then the five PNG row filters in C on the host
(`io/csrc/png.c`, built at first use by `kernels/_build.host_fn`).
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import time
import zlib

import numpy as np

from ..core import backend
from ..kernels import _build
from . import dataset as dataset_mod, logs, replay as replay_mod

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def load_image(path: str) -> np.ndarray:
    """Load a grayscale image as (H, W) float32 in [0, 255]: `.npy`,
    binary (P5) or ASCII (P2) `.pgm`, or an 8-bit PNG of colour type 0
    (grayscale) or 2 (RGB); anything else raises ValueError."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if path.endswith(".pgm"):
        with open(path, "rb") as f:
            magic = f.readline().strip()
            if magic not in (b"P5", b"P2"):
                raise ValueError(f"unsupported PGM magic {magic!r}")
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = (int(x) for x in line.split())
            maxval = int(f.readline())
            if magic == b"P5":
                dt = np.uint8 if maxval < 256 else ">u2"
                img = np.frombuffer(f.read(), dtype=dt, count=w * h)
            else:
                img = np.asarray(f.read().split(), dtype=np.int32)[: w * h]
            return img.reshape(h, w).astype(np.float32)
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(_PNG_SIGNATURE):
        return read_png(raw, path).astype(np.float32)
    raise ValueError(f"{path}: unsupported image format (the port reads "
                     f".npy, PGM P5/P2 and 8-bit grayscale or RGB PNG)")


def read_png(raw: bytes, name: str = "PNG") -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG of colour type 0 or 2 to (H, W)
    uint8. RGB becomes grayscale as PIL's `convert("L")` computes it:
    (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    off, idat, hdr = len(_PNG_SIGNATURE), [], None
    while off + 8 <= len(raw):
        n, tag = struct.unpack_from(">I4s", raw, off)
        data = raw[off + 8:off + 8 + n]
        off += 12 + n  # length, tag, data, CRC
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in (0, 2) or interlace != 0:
        raise ValueError(
            f"{name}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); the port reads 8-bit, "
            f"non-interlaced grayscale (0) or RGB (2)")
    bpp = 1 if ctype == 0 else 3
    stride = w * bpp
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError(f"{name}: PNG image data is truncated")
    rows = buf[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    unfilter = _build.host_fn("png.c", "kmt_png_unfilter",
                              [ctypes.c_void_p, ctypes.c_void_p]
                              + [ctypes.c_int] * 3)
    bad = unfilter(rows.ctypes.data, out.ctypes.data, h, w, bpp)
    if bad:
        raise ValueError(f"{name}: PNG row {bad - 1} has filter type "
                         f"{rows[bad - 1, 0]}")
    if ctype == 0:
        return out
    rgb = out.reshape(h, w, 3).astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def check_keyframes(vio, n_kf: int, what: str) -> None:
    """The VIO pipeline must hold one keyframe for each it made: its
    final keyframe states are read in place of the snapshots
    process_frame returned, and paired with their frames."""
    if len(vio.keyframes) != n_kf:
        raise RuntimeError(
            f"{what}: the VIO pipeline holds {len(vio.keyframes)} keyframes "
            f"but made {n_kf}; its keyframe list would not line up with its "
            f"frames")


def euroc_config(session, height: int, width: int):
    """The VIO `PipelineConfig` the converter runs a session with, as the
    JAX package's converter builds it: the session's pinhole intrinsics
    (or a focal of 0.85 x width at the image centre), its stereo baseline
    when it has a right camera, a window of 8, 96 features, KLT window 12,
    GFTT minimum distance 6, 200 RANSAC hypotheses, every frame a
    keyframe."""
    from ..vio import pipeline as vio_pipeline
    from ..vio.undistort import CameraModel

    if session.intrinsics is not None:
        fu, fv, cu, cv = session.intrinsics
    else:
        fu = fv = 0.85 * width
        cu, cv = width / 2.0, height / 2.0
    return vio_pipeline.PipelineConfig()._replace(
        cam=CameraModel(fx=fu, fy=fv, cx=cu, cy=cv),
        baseline=session.baseline if session.cam1_files else 0.0,
        window_size=8, max_features=96,
        gftt=vio_pipeline.tracking.GfttParams(
            max_features=96, min_distance=6, quality_level=0.001),
        klt=vio_pipeline.tracking.KltParams(win_size=12, max_level=3,
                                            max_iter=20),
        min_intra_keyframe_time=0.0, disparity_threshold=0.0,
        ransac_iterations=200, min_mono_inliers=8, min_stereo_inliers=4,
    )


def euroc_to_observations(root: str, cfg=None, max_frames: int | None = None,
                          log=print, device="cuda", stats: dict | None = None):
    """Run the VIO pipeline over one EuRoC session on `device` (the card
    unless told otherwise); return (ObservationStream, EurocSession,
    keyframe poses (R (T, 3, 3), t (T, 3))).

    cfg: the pipeline's configuration, `euroc_config(session, H, W)` when
    None. `stats`, when given, receives `io_s` (reading image files),
    `vio_s` (the pipeline, synchronised), `frame_s` (each keyframe-making
    frame's time, image upload included) and `rejection_log`."""
    from ..vio import pipeline as vio_pipeline

    dev = backend.resolve_device(device)
    s = dataset_mod.load_euroc(root)
    if len(s.cam_files) == 0:
        raise ValueError(f"no cam0 frames under {root}")
    t_io = time.perf_counter()
    first = load_image(s.cam_files[0])
    io_s = time.perf_counter() - t_io
    if cfg is None:
        cfg = euroc_config(s, *first.shape)
    vio = vio_pipeline.VioPipeline(cfg, device=dev)
    n = len(s.cam_files) if max_frames is None else min(len(s.cam_files),
                                                        max_frames)
    imu_i, n_kf, frame_s, vio_s = 0, 0, [], 0.0
    for k in range(n):
        ts = s.cam_ts[k]
        while imu_i < len(s.imu_ts) and s.imu_ts[imu_i] <= ts:
            vio.add_imu(s.imu_ts[imu_i], s.gyro[imu_i], s.accel[imu_i])
            imu_i += 1
        t_io = time.perf_counter()
        left = first if k == 0 else load_image(s.cam_files[k])
        right = (load_image(s.cam1_files[k])
                 if k < len(s.cam1_files) else None)
        t_vio = time.perf_counter()
        io_s += t_vio - t_io
        # a keyframe ends in host reads of its results: synchronised
        kf = vio.process_frame(ts, left, right)
        t_end = backend.synced_clock(dev)
        vio_s += t_end - t_vio
        if kf is not None:
            frame_s.append(t_end - t_vio)
            n_kf += 1
    if not n_kf:
        raise ValueError(f"VIO produced no keyframes for {root}")
    # the FINAL keyframe states, not the snapshots process_frame returned:
    # gravity alignment and the sliding-window re-solves replace entries
    # of vio.keyframes with refined poses after process_frame returns
    check_keyframes(vio, n_kf, root)
    kfs = list(vio.keyframes)
    T, K = len(kfs), cfg.max_features
    desc = np.zeros((T, K, 32), np.uint8)
    bear = np.zeros((T, K, 3), np.float32)
    lm = np.zeros((T, K, 3), np.float32)
    val = np.zeros((T, K), bool)
    ts_out = np.zeros(T, np.float64)
    for t, kf in enumerate(kfs):
        m = min(K, kf.descriptors.shape[0])
        desc[t, :m] = kf.descriptors[:m]
        bear[t, :m] = kf.bearings[:m]
        lm[t, :m] = kf.landmarks[:m]
        # a mono session has no stereo landmarks: validity alone
        val[t, :m] = ((kf.valid & kf.lm_valid)[:m] if cfg.baseline > 0
                      else kf.valid[:m])
        ts_out[t] = kf.timestamp
    obs = replay_mod.ObservationStream(
        descriptors=desc, bearings=bear, landmarks=lm, valid=val,
        timestamps=ts_out)
    if stats is not None:
        stats.update(io_s=io_s, vio_s=vio_s, frame_s=frame_s,
                     rejection_log=list(vio.rejection_log))
    R_kf = np.stack([kf.R for kf in kfs])
    t_kf = np.stack([kf.t for kf in kfs])
    return obs, s, (R_kf, t_kf)


def convert_sessions(roots: list, out_dir: str, cfg=None,
                     max_frames: int | None = None, log=print,
                     device="cuda") -> dict:
    """Convert one EuRoC session per robot into the replay layout:
    out_dir/obs_robot<k>.npz (+ gt_robot<k>.tum when GT exists). Returns
    {robot: {"obs": path, "gt": path | None, "n_keyframes": T}}."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for r, root in enumerate(roots):
        obs, s, _poses = euroc_to_observations(
            root, cfg=cfg, max_frames=max_frames, device=device)
        p = replay_mod.obs_path(out_dir, r)
        replay_mod.save_observations(p, obs)
        gt_path = None
        if len(s.gt_ts):
            gt_path = os.path.join(out_dir, f"gt_robot{r}.tum")
            logs.write_tum(gt_path, s.gt_ts, s.gt_t, s.gt_q)
        out[r] = dict(obs=p, gt=gt_path,
                      n_keyframes=obs.descriptors.shape[0])
        log(f"[convert] robot {r}: {root} -> {p} "
            f"({obs.descriptors.shape[0]} keyframes"
            f"{', GT' if gt_path else ''})")
    return out


def resolve_session_root(root: str, work_dir: str, robot: int,
                         max_frames: int | None = None,
                         log=print) -> str:
    """Accepts either an EuRoC ASL directory or a .bag file; bags are
    extracted into work_dir/bag_robot<k>/ as an ASL tree first
    (io/rosbag.py), so every downstream consumer sees one format."""
    if root.endswith(".bag") and os.path.isfile(root):
        from . import rosbag as rosbag_mod

        out_root = os.path.join(work_dir, f"bag_robot{robot}")
        return rosbag_mod.rosbag_to_asl(root, out_root,
                                        max_frames=max_frames, log=log)
    return root


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Convert EuRoC session trees OR rosbag1 files to "
                    "replay observation streams (obs_robot<k>.npz) + "
                    "GT TUM")
    p.add_argument("--euroc", action="append", default=[],
                   help="EuRoC session root (one per robot, repeatable)")
    p.add_argument("--bag", action="append", default=[],
                   help="rosbag1 file (one per robot, repeatable; "
                        "sensor_msgs Image/Imu + nav_msgs Odometry GT)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    dev = backend.resolve_device(args.device)
    roots = list(args.euroc)
    log = lambda m: print(m, file=sys.stderr)  # noqa: E731
    if not roots and not args.bag:
        p.error("need at least one --euroc or --bag")
    for b in args.bag:
        roots.append(resolve_session_root(
            b, args.out, len(roots), max_frames=args.max_frames, log=log))
    convert_sessions(roots, args.out, max_frames=args.max_frames, log=log,
                     device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
