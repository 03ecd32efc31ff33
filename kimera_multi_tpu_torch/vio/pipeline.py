"""The VIO pipeline: stereo tracking front-end + fixed-lag smoother (the
JAX package's vio/pipeline.py).

Role of Kimera-VIO's `Pipeline` module graph: data provider -> front-end
(KLT tracking, keyframe gates, mono/stereo RANSAC outlier rejection) ->
back-end (fixed-lag smoother) -> keyframe products for loop closure.
Reference envelope: stereo + IMU, 300 features a frame, pyramidal KLT,
8-point mono (or 5-point) and Arun / 1-point stereo rejection, a 25-state
horizon, radtan undistortion.

Host-driven, as in the JAX package: a host loop over device stages.
Everything per feature is fixed shape and masked:

  * refill is a masked rank-assign (detections scored, distance-gated
    against live tracks, placed into free slots), one batch on the device;
  * window landmarks are slot tensors that stay on the device: a track
    keeps its slot for life, so the smoother's (L, W) observations are
    gathered from the ring buffers with an id-equality mask (a slot
    reused inside the window drops its earlier occupant's observations,
    as in the JAX package);
  * stereo depth enters the smoother as a range residual per observation.

The host reads back what the JAX package reads back: tracked points and
masks, bearings, landmarks, descriptors, rejection results and the
solved window states. The reject step's RANSAC runs the port's
`ransac_essential` (or `ransac_essential_5pt`) and `ransac_arun` with a
candidate axis of 1: K4, K9 and K8 on the card.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import backend, lie, rng as rngmod
from ..kernels import ransac as ransac_mod
from ..kernels.score import first_argmax
from . import descriptors as desc_mod, imu as imu_mod, smoother, tracking
from .undistort import CameraModel, undistort_points


class PipelineConfig(NamedTuple):
    gftt: tracking.GfttParams = tracking.GfttParams()
    klt: tracking.KltParams = tracking.KltParams()
    vio: smoother.VioConfig = smoother.VioConfig()
    imu: imu_mod.ImuParams = imu_mod.ImuParams()
    min_intra_keyframe_time: float = 0.2
    max_intra_keyframe_time: float = 5.0
    disparity_threshold: float = 0.5  # px mean disparity to force keyframe
    window_size: int = 25  # nr_states horizon
    max_features: int = 300  # maxFeaturesPerFrame
    imu_samples_per_kf: int = 128  # preintegration capacity between kfs
    cam: CameraModel = CameraModel(fx=200.0, fy=200.0, cx=80.0, cy=60.0)
    baseline: float = 0.095  # stereo baseline (m); <= 0 disables stereo
    min_disparity_px: float = 0.25  # stereo acceptance gate
    epipolar_tol_px: float = 2.0  # |v_left - v_right| stereo gate
    disparity_sigma_px: float = 0.5  # KLT disparity noise for depth sigma
    # outlier rejection (FrontendParams.yaml)
    ransac_mono_threshold: float = 1e-6
    ransac_stereo_threshold: float = 0.8
    ransac_iterations: int = 500
    ransac_use_1point_stereo: bool = False
    # the mono gate is 8-point by default, as in the JAX package (its
    # documented deviation from the reference's 5-point gate)
    use_5pt_mono: bool = False
    min_mono_inliers: int = 10
    min_stereo_inliers: int = 5
    # attitude init by accelerometer gravity alignment
    gravity_align: bool = True
    base_seed: int = 0

    @classmethod
    def from_params_folder(cls, folder: str, **overrides):
        """Build the config from a reference params folder (params/D455):
        LeftCameraParams intrinsics/distortion, FrontendParams tracking +
        rejection envelope, BackendParams horizon."""
        from ..io.config import load_opencv_yaml

        cam_y = load_opencv_yaml(os.path.join(folder,
                                              "LeftCameraParams.yaml"))
        fe = load_opencv_yaml(os.path.join(folder, "FrontendParams.yaml"))
        be = load_opencv_yaml(os.path.join(folder, "BackendParams.yaml"))
        intr = cam_y.get("intrinsics", [380.0, 380.0, 320.0, 240.0])
        dist = cam_y.get("distortion_coefficients", [0.0, 0.0, 0.0, 0.0])
        cam = CameraModel(fx=float(intr[0]), fy=float(intr[1]),
                          cx=float(intr[2]), cy=float(intr[3]),
                          k1=float(dist[0]), k2=float(dist[1]),
                          p1=float(dist[2]), p2=float(dist[3]))
        kw = dict(
            cam=cam,
            klt=tracking.KltParams(
                win_size=int(fe.get("klt_win_size", 24)),
                max_iter=int(fe.get("klt_max_iter", 30)),
                max_level=int(fe.get("klt_max_level", 4)),
                eps=float(fe.get("klt_eps", 0.1))),
            gftt=tracking.GfttParams(
                max_features=int(fe.get("maxFeaturesPerFrame", 300)),
                quality_level=float(fe.get("quality_level", 0.001)),
                min_distance=int(fe.get("min_distance", 20))),
            max_features=int(fe.get("maxFeaturesPerFrame", 300)),
            min_intra_keyframe_time=float(
                fe.get("min_intra_keyframe_time", 0.2)),
            max_intra_keyframe_time=float(
                fe.get("max_intra_keyframe_time", 5.0)),
            disparity_threshold=float(fe.get("disparityThreshold", 0.5)),
            window_size=int(be.get("nr_states", 25)),
            ransac_mono_threshold=float(
                fe.get("ransac_threshold_mono", 1e-6)),
            ransac_stereo_threshold=float(
                fe.get("ransac_threshold_stereo", 0.8)),
            ransac_iterations=int(fe.get("ransac_max_iterations", 500)),
            ransac_use_1point_stereo=bool(
                fe.get("ransac_use_1point_stereo", 0)),
        )
        kw.update(overrides)
        return cls(**kw)


class KeyframeOutput(NamedTuple):
    """Per-keyframe product (feeds the loop-closure front-end)."""

    timestamp: float
    R: np.ndarray
    t: np.ndarray
    v: np.ndarray
    track_ids: np.ndarray  # (N,) persistent feature ids (-1 invalid)
    pts: np.ndarray  # (N, 2) pixel positions (distorted/raw)
    bearings: np.ndarray  # (N, 3) undistorted unit bearings
    landmarks: np.ndarray  # (N, 3) cam-frame 3D from stereo (0 if invalid)
    lm_valid: np.ndarray  # (N,)
    descriptors: np.ndarray  # (N, 32) uint8
    valid: np.ndarray  # (N,) feature liveness after rejection
    mono_inliers: int
    stereo_inliers: int
    n_rejected: int


class RejectionStats(NamedTuple):
    mono_inliers: int = 0
    stereo_inliers: int = 0
    n_corresp: int = 0
    n_rejected: int = 0


class VioPipeline:
    """Host-driven stereo(+mono)-inertial odometry over device stages.
    Runs on the card unless `device="cpu"` is given."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.device = dev = backend.resolve_device(device)
        N = cfg.max_features
        W = cfg.window_size
        self.prev_img = None
        self.prev_ts = None
        self.last_kf_ts = None
        self.pts = np.zeros((N, 2), np.float32)
        self.track_ids = np.full(N, -1, np.int64)
        self.valid = np.zeros(N, bool)
        self.next_id = 0
        self.imu_buf: list = []  # (ts, gyro, accel) since last keyframe
        # window ring buffers: device-resident slot tensors
        f32 = dict(dtype=torch.float32, device=dev)
        self.win_bear = torch.zeros((W, N, 3), **f32)
        self.win_tids = torch.full((W, N), -1, dtype=torch.int32, device=dev)
        self.win_valid = torch.zeros((W, N), dtype=torch.bool, device=dev)
        self.win_depth = torch.zeros((W, N), **f32)
        self.win_depth_sig = torch.ones((W, N), **f32)
        self.win_depth_valid = torch.zeros((W, N), dtype=torch.bool,
                                           device=dev)
        self.win_odo_R = np.tile(np.eye(3, dtype=np.float32), (W - 1, 1, 1))
        self.win_odo_t = np.zeros((W - 1, 3), np.float32)
        self.win_odo_valid = np.zeros(W - 1, bool)
        self.win_pre: list = []
        self.keyframes: list[KeyframeOutput] = []
        self.rejection_log: list[RejectionStats] = []
        self._last_accel_mean = None
        self._ext_odo = None

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def _klt(self, i0, i1, pts, valid):
        return tracking.klt_track(i0, i1, pts, valid, self.cfg.klt)

    def _bearing(self, pts: torch.Tensor) -> torch.Tensor:
        cam = self.cfg.cam
        has_dist = any(abs(k) > 0 for k in (cam.k1, cam.k2, cam.p1, cam.p2))
        und = undistort_points(pts, cam) if has_dist else pts
        x = (und[:, 0] - cam.cx) / cam.fx
        y = (und[:, 1] - cam.cy) / cam.fy
        b = torch.stack([x, y, torch.ones_like(x)], -1)
        return b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))

    def _stereo(self, left, right, pts, valid):
        """Left->right KLT; disparity -> depth -> cam-frame 3D."""
        cfg = self.cfg
        pts_r, ok = self._klt(left, right, pts, valid)
        disp = pts[:, 0] - pts_r[:, 0]
        vdiff = torch.abs(pts[:, 1] - pts_r[:, 1])
        good = (ok & valid & (disp > cfg.min_disparity_px)
                & (vdiff < cfg.epipolar_tol_px))
        z = cfg.cam.fx * cfg.baseline / torch.clamp(
            disp, min=cfg.min_disparity_px)
        bear = self._bearing(pts)
        # range along the bearing s.t. the z-component equals depth z
        rng = z / torch.clamp(bear[:, 2], min=1e-3)
        lm = bear * rng[:, None]
        return torch.where(good[:, None], lm, 0.0), rng, good

    def _refill(self, pts, valid, tids, det_pts, det_scores, det_valid,
                next_id: int):
        """Masked rank-assign: the best detections far from live tracks
        fill free slots, in one fixed-shape batch."""
        min_d2 = float(self.cfg.gftt.min_distance) ** 2
        e = det_pts[:, None, :] - pts[None, :, :]
        d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
        near_live = torch.any((d2 < min_d2) & valid[None, :], dim=1)
        ok = det_valid & ~near_live
        score = torch.where(ok, det_scores, -torch.inf)
        # ok candidates first, best first; equal scores by index
        order = torch.argsort(-score, stable=True)
        n_cand = torch.sum(ok)
        free = ~valid
        free_rank = torch.cumsum(free, dim=0) - 1  # rank among free slots
        D = det_pts.shape[0]
        take = free & (free_rank < n_cand) & (free_rank < D)
        src = torch.clamp(free_rank, 0, D - 1)
        new_pts = torch.where(take[:, None], det_pts[order][src], pts)
        new_ids = torch.where(take, next_id + free_rank, tids)
        n_new = torch.minimum(torch.sum(free), n_cand)
        return new_pts, valid | take, new_ids, n_new

    def _reject(self, key, bear_prev, bear_cur, lm_prev, lm_cur, lm_ok,
                corresp, R_imu, use_imu_rot: bool):
        """Per-keyframe outlier rejection (outlierRejectionMono /
        outlierRejectionStereo): mono essential RANSAC over bearing
        correspondences, then 3d3d RANSAC (Arun, or 1-point translation
        when the IMU rotation is trusted) over stereo landmarks. Returns
        the keep mask and the relative pose."""
        cfg = self.cfg
        soa = lambda a: a.T.contiguous()[None]  # (K, 3) -> (1, 3, K)
        kmono = rngmod.derive(key, rngmod.Stream.RANSAC_MONO)[None]
        mono_fn = (ransac_mod.ransac_essential_5pt if cfg.use_5pt_mono
                   else ransac_mod.ransac_essential)
        mono = mono_fn(kmono, soa(bear_prev), soa(bear_cur), corresp[None],
                       threshold=cfg.ransac_mono_threshold,
                       n_hyp=cfg.ransac_iterations,
                       min_inliers=cfg.min_mono_inliers)
        kst = rngmod.derive(key, rngmod.Stream.RANSAC_STEREO)[None]
        both3d = corresp & lm_ok
        p, q = soa(lm_prev), soa(lm_cur)
        st_full = ransac_mod.ransac_arun(
            kst, p, q, both3d[None], threshold=cfg.ransac_stereo_threshold,
            n_hyp=cfg.ransac_iterations, min_inliers=cfg.min_stereo_inliers)
        st_1pt = ransac_mod.ransac_translation_known_rotation(
            kst, p, q, R_imu[None], both3d[None],
            threshold=cfg.ransac_stereo_threshold,
            min_inliers=cfg.min_stereo_inliers)
        pick_1pt = torch.tensor(use_imu_rot and cfg.ransac_use_1point_stereo,
                                device=self.device)
        st = {k: torch.where(pick_1pt, st_1pt[k][0], st_full[k][0])
              for k in ("R", "t", "inliers", "n_inliers", "ok")}
        mono = {k: v[0] for k, v in mono.items()}
        # drop correspondences that are not inliers of the mono gate (and
        # of the stereo gate where 3D is present), but only where the
        # model itself validated: a failed gate means degenerate geometry
        # (the reference's LOW_DISPARITY path), not all outliers
        keep = torch.where(corresp & mono["ok"], mono["inliers"], True)
        keep = keep & torch.where(both3d & st["ok"], st["inliers"], True)
        # T^{cur}_{prev} from Arun (q = R p + t) -> T^{prev}_{cur}
        R_rel, t_rel = lie.se3_inverse(st["R"], st["t"])
        return {"keep": keep, "mono_inliers": mono["n_inliers"],
                "stereo_inliers": st["n_inliers"], "mono_ok": mono["ok"],
                "stereo_ok": st["ok"], "R_rel": R_rel, "t_rel": t_rel}

    # ------------------------------------------------------------------
    def add_imu(self, ts: float, gyro, accel) -> None:
        self.imu_buf.append((ts, np.asarray(gyro, np.float32),
                             np.asarray(accel, np.float32)))

    def add_external_odometry(self, R_rel, t_rel) -> None:
        """Relative pose of the NEXT keyframe in the previous keyframe's
        body frame, from an external odometry source."""
        self._ext_odo = (np.asarray(R_rel, np.float32),
                         np.asarray(t_rel, np.float32))

    def process_frame(self, ts: float, left: np.ndarray,
                      right: np.ndarray | None = None):
        """Returns a KeyframeOutput when this frame becomes a keyframe."""
        cfg = self.cfg
        imgj = self._dev(np.asarray(left, np.float32))
        if self.prev_img is None:
            pts, _scores, det_valid = tracking.gftt_detect(imgj, cfg.gftt)
            self.pts = pts.cpu().numpy()
            self.valid = det_valid.cpu().numpy()
            self.track_ids = np.where(
                self.valid, np.arange(len(self.pts)) + self.next_id, -1)
            self.next_id += int(self.valid.sum())
            self.prev_img = imgj
            self.prev_ts = ts
            self.last_kf_ts = ts
            return self._make_keyframe(ts, imgj, right)

        pts1, tracked = self._klt(self.prev_img, imgj, self._dev(self.pts),
                                  self._dev(self.valid))
        pts1 = pts1.cpu().numpy()
        tracked = tracked.cpu().numpy() & self.valid
        disparity = (np.linalg.norm((pts1 - self.pts)[tracked], axis=1)
                     .mean() if tracked.any() else 0.0)
        self.pts = pts1
        self.valid = tracked
        self.track_ids = np.where(tracked, self.track_ids, -1)
        self.prev_img = imgj
        self.prev_ts = ts

        dt_kf = ts - self.last_kf_ts
        is_kf = (dt_kf >= cfg.min_intra_keyframe_time and
                 (disparity > cfg.disparity_threshold
                  or dt_kf >= cfg.max_intra_keyframe_time))
        if not is_kf:
            return None
        self.last_kf_ts = ts
        return self._make_keyframe(ts, imgj, right)

    # ------------------------------------------------------------------
    def _preintegrate_buffer(self, prev_ts: float):
        """Preintegration of the buffered samples (at most
        imu_samples_per_kf). The JAX package pads them with zero intervals
        to that capacity; padding steps keep the carry bit for bit, so
        only the filled rows are integrated."""
        S = self.cfg.imu_samples_per_kf
        buf = self.imu_buf[:S]
        n = len(buf)
        gyro = np.zeros((n, 3), np.float32)
        accel = np.zeros((n, 3), np.float32)
        dts = np.zeros(n, np.float32)
        t_prev = prev_ts
        for i, (tsi, g, a) in enumerate(buf):
            gyro[i], accel[i] = g, a
            dts[i] = max(tsi - t_prev, 0.0)
            t_prev = tsi
        self._last_accel_mean = accel.mean(0) if buf else None
        self.imu_buf = []
        z = torch.zeros(3, dtype=torch.float32, device=self.device)
        return imu_mod.preintegrate(self._dev(gyro), self._dev(accel),
                                    self._dev(dts), z, z, self.cfg.imu)

    def _make_keyframe(self, ts: float, imgj, right):
        cfg = self.cfg
        kf_idx = len(self.keyframes)
        N = cfg.max_features
        dev = self.device
        right_t = (self._dev(np.asarray(right, np.float32))
                   if right is not None and cfg.baseline > 0 else None)

        # IMU preintegration since the previous keyframe
        pre = None
        if kf_idx > 0 and self.imu_buf:
            pre = self._preintegrate_buffer(self.keyframes[-1].timestamp)

        # gravity alignment at bootstrap: a near-static accelerometer
        # measures f = -R^T g, so the first keyframe's attitude maps the
        # mean specific force to +|g| z_world
        if kf_idx == 1 and cfg.gravity_align and pre is not None and \
                self._last_accel_mean is not None:
            f = self._last_accel_mean
            fn = f / max(np.linalg.norm(f), 1e-6)
            z = np.asarray([0.0, 0.0, 1.0], np.float32)  # -GRAVITY dir
            axis = np.cross(fn, z)
            s = np.linalg.norm(axis)
            c = float(fn @ z)
            if s > 1e-8:
                w = axis / s * np.arctan2(s, c)
                R0g = lie.so3_exp(self._dev(w, torch.float32)).cpu().numpy()
            else:
                R0g = (np.eye(3, dtype=np.float32) if c > 0
                       else np.diag([1.0, -1.0, -1.0]).astype(np.float32))
            self.keyframes[0] = self.keyframes[0]._replace(
                R=R0g @ self.keyframes[0].R)

        # ---- outlier rejection vs the previous keyframe ---------------
        stats = RejectionStats()
        odo = None
        if kf_idx > 0:
            prev = self.keyframes[-1]
            corresp = (self.valid & prev.valid
                       & (self.track_ids == prev.track_ids)
                       & (self.track_ids >= 0))
            pts_t = self._dev(self.pts)
            bear_cur = self._bearing(pts_t)
            if int(corresp.sum()) >= 8:
                if right_t is not None:
                    lm_cur3, _, lm_ok_cur = self._stereo(
                        imgj, right_t, pts_t, self._dev(self.valid))
                else:
                    lm_cur3 = torch.zeros((N, 3), dtype=torch.float32,
                                          device=dev)
                    lm_ok_cur = torch.zeros(N, dtype=torch.bool, device=dev)
                key = rngmod.derive(rngmod.base_key(cfg.base_seed, dev),
                                    rngmod.Stream.VIO, kf_idx)
                R_imu = (pre.dR if pre is not None else
                         torch.eye(3, dtype=torch.float32, device=dev))
                out = self._reject(
                    key, self._dev(prev.bearings), bear_cur,
                    self._dev(prev.landmarks), lm_cur3,
                    self._dev(prev.lm_valid) & lm_ok_cur,
                    self._dev(corresp), R_imu, pre is not None)
                keep = out["keep"].cpu().numpy()
                n_rej = int((corresp & ~keep).sum())
                self.valid = self.valid & keep
                self.track_ids = np.where(self.valid, self.track_ids, -1)
                stats = RejectionStats(
                    mono_inliers=int(out["mono_inliers"]),
                    stereo_inliers=int(out["stereo_inliers"]),
                    n_corresp=int(corresp.sum()), n_rejected=n_rej)
                # the stereo-RANSAC pose serves rejection and the velocity
                # bootstrap only, not as a between factor: the reference
                # feeds addBetweenFactor from external odometry only
                if bool(out["stereo_ok"]):
                    odo = (out["R_rel"].cpu().numpy(),
                           out["t_rel"].cpu().numpy())
        self.rejection_log.append(stats)

        # velocity bootstrap from the first stereo-RANSAC relative pose
        if kf_idx == 1 and odo is not None:
            dt_b = max(ts - self.keyframes[0].timestamp, 1e-3)
            v_boot = (self.keyframes[0].R @ odo[1] / dt_b).astype(
                np.float32)
            self.keyframes[0] = self.keyframes[0]._replace(v=v_boot)

        # ---- refill to budget (masked rank-assign) ---------------------
        det_pts, det_scores, det_valid = tracking.gftt_detect(imgj, cfg.gftt)
        new_pts, new_valid, new_ids, n_new = self._refill(
            self._dev(self.pts), self._dev(self.valid),
            self._dev(self.track_ids), det_pts, det_scores, det_valid,
            self.next_id)
        self.pts = new_pts.cpu().numpy()
        self.valid = new_valid.cpu().numpy()
        self.track_ids = new_ids.cpu().numpy()
        self.next_id += int(n_new)

        # ---- stereo depth + bearings + descriptors at the keyframe ----
        pts_t, valid_t = self._dev(self.pts), self._dev(self.valid)
        bear_t = self._bearing(pts_t)
        if right_t is not None:
            lm_t, rng_t, lm_ok_t = self._stereo(imgj, right_t, pts_t,
                                                valid_t)
        else:
            lm_t = torch.zeros((N, 3), dtype=torch.float32, device=dev)
            rng_t = torch.zeros(N, dtype=torch.float32, device=dev)
            lm_ok_t = torch.zeros(N, dtype=torch.bool, device=dev)
        desc = desc_mod.describe(imgj, pts_t, valid_t).cpu().numpy()
        bear = bear_t.cpu().numpy()
        lm = lm_t.cpu().numpy()
        lm_ok = lm_ok_t.cpu().numpy()

        # ---- pose guess from IMU propagation ---------------------------
        if kf_idx == 0:
            R0 = np.eye(3, dtype=np.float32)
            t0 = np.zeros(3, np.float32)
            v0 = np.zeros(3, np.float32)
        else:
            prev = self.keyframes[-1]
            if pre is not None:
                dt = float(pre.dt)
                g = np.asarray(imu_mod.GRAVITY, np.float32)
                dR, dv, dp = (x.cpu().numpy() for x in (pre.dR, pre.dv,
                                                        pre.dp))
                R0 = prev.R @ dR
                v0 = prev.v + g * dt + prev.R @ dv
                t0 = (prev.t + prev.v * dt + 0.5 * g * dt * dt
                      + prev.R @ dp)
            else:
                R0, t0, v0 = prev.R, prev.t, prev.v

        kf = KeyframeOutput(
            timestamp=ts, R=np.asarray(R0, np.float32),
            t=np.asarray(t0, np.float32), v=np.asarray(v0, np.float32),
            track_ids=self.track_ids.copy(), pts=self.pts.copy(),
            bearings=bear, landmarks=lm, lm_valid=lm_ok & self.valid,
            descriptors=desc, valid=self.valid.copy(),
            mono_inliers=stats.mono_inliers,
            stereo_inliers=stats.stereo_inliers,
            n_rejected=stats.n_rejected)
        self.keyframes.append(kf)
        self.win_pre.append(pre)

        # ---- push the slot row into the device-resident ring buffers ---
        W = cfg.window_size
        self._push_window(kf_idx >= W, W - 1 if kf_idx >= W else kf_idx,
                          bear_t, self._dev(np.where(
                              self.valid, self.track_ids, -1), torch.int32),
                          valid_t, rng_t, lm_ok_t & valid_t)
        if kf_idx >= 1:
            if kf_idx >= W:
                self.win_odo_R[:-1] = self.win_odo_R[1:]
                self.win_odo_t[:-1] = self.win_odo_t[1:]
                self.win_odo_valid[:-1] = self.win_odo_valid[1:]
                eslot = W - 2
            else:
                eslot = kf_idx - 1
            if self._ext_odo is not None:
                self.win_odo_R[eslot], self.win_odo_t[eslot] = self._ext_odo
                self.win_odo_valid[eslot] = True
                self._ext_odo = None
            else:
                self.win_odo_R[eslot] = np.eye(3, dtype=np.float32)
                self.win_odo_valid[eslot] = False

        if kf_idx >= 1:
            self._optimize_window()
        return self.keyframes[-1]

    # ------------------------------------------------------------------
    def _push_window(self, shift: bool, slot: int, bear, tids, valid,
                     rng_depth, depth_ok) -> None:
        """Shift the window ring buffers by one when the window is full,
        then write the new keyframe's row at `slot`, on the device."""
        cfg = self.cfg
        fxb = max(cfg.cam.fx * cfg.baseline, 1e-6)
        names = ("win_bear", "win_tids", "win_valid", "win_depth",
                 "win_depth_sig", "win_depth_valid")
        if shift:
            for n in names:
                a = getattr(self, n)
                setattr(self, n, torch.cat([a[1:], a[-1:]]))
        # stereo range noise: sigma_Z = sigma_disp * Z^2 / (fx * b)
        dsig = torch.clamp(cfg.disparity_sigma_px * rng_depth * rng_depth
                           / fxb, min=cfg.vio.depth_sigma)
        for n, row in zip(names, (bear, tids, valid, rng_depth, dsig,
                                  depth_ok)):
            getattr(self, n)[slot] = row

    def _assemble_window(self, Wn: int, state0, pre, imu_valid, odo_R,
                         odo_t, odo_valid) -> smoother.VioWindow:
        """The smoother's landmark tensors from the ring buffers, on the
        device: track ids with >= 2 observations in the window (sort +
        segments), the L = max_features most observed (ties: the smaller
        id), and each one's slot per frame."""
        L = self.cfg.max_features
        BIG = 2 ** 30
        wb, wt, wv = (self.win_bear[:Wn], self.win_tids[:Wn],
                      self.win_valid[:Wn])
        wd, wds, wdv = (self.win_depth[:Wn], self.win_depth_sig[:Wn],
                        self.win_depth_valid[:Wn])
        flat = torch.where(wv, wt, BIG).reshape(-1)
        s = torch.sort(flat).values
        ok = s < BIG
        new_seg = torch.cat([ok[:1], (s[1:] != s[:-1]) & ok[1:]])
        seg_id = torch.cumsum(new_seg, dim=0) - 1  # -1 before the first
        M = flat.shape[0]
        sid = torch.clamp(seg_id, 0, M - 1)
        counts = torch.zeros(M, dtype=torch.int32, device=flat.device)
        counts.scatter_add_(0, sid, (ok & (seg_id >= 0)).to(torch.int32))
        seg_val = torch.full((M,), BIG, dtype=torch.int32, device=flat.device)
        seg_val.scatter_reduce_(0, sid, torch.where(ok, s, BIG), "amin")
        # top-L by count among segments with >= 2 observations
        key = torch.where(counts >= 2, counts, 0)
        topv, topi = torch.sort(key, descending=True, stable=True)
        topv, topi = topv[:L], topi[:L]
        sel = torch.where(topv >= 2, seg_val[topi], -2)  # (L,)
        match = (wt[None] == sel[:, None, None]) & wv[None]  # (L, Wn, N)
        has = match.any(-1)
        slot = first_argmax(match.to(torch.int32))  # (L, Wn)
        frames = torch.arange(Wn, device=flat.device)[None, :]
        return smoother.VioWindow(
            pre=pre, imu_valid=imu_valid, bearings=wb[frames, slot],
            obs_valid=has, odo_R=odo_R, odo_t=odo_t, odo_valid=odo_valid,
            zero_vel=torch.zeros(Wn, dtype=torch.bool, device=flat.device),
            anchor=smoother.VioState(*(x[:1] for x in state0)),
            depths=wd[frames, slot], depth_valid=wdv[frames, slot] & has,
            depth_sigmas=wds[frames, slot])

    def _optimize_window(self):
        cfg = self.cfg
        Wn = min(cfg.window_size, len(self.keyframes))
        base = len(self.keyframes) - Wn
        kfs = self.keyframes[base:]
        pres = self.win_pre[base + 1: base + Wn]
        imu_valid = self._dev([p is not None for p in pres], torch.bool)
        pre = imu_mod.stack_pre([p if p is not None
                                 else _dummy_pre(self.device) for p in pres])
        z = torch.zeros((Wn, 3), dtype=torch.float32, device=self.device)
        state0 = smoother.VioState(
            R=self._dev(np.stack([k.R for k in kfs])),
            t=self._dev(np.stack([k.t for k in kfs])),
            v=self._dev(np.stack([k.v for k in kfs])), bg=z, ba=z)
        win = self._assemble_window(
            Wn, state0, pre, imu_valid, self._dev(self.win_odo_R[:Wn - 1]),
            self._dev(self.win_odo_t[:Wn - 1]),
            self._dev(self.win_odo_valid[:Wn - 1]))
        solved = smoother.solve_window(state0, win, cfg.vio)
        R_s, t_s, v_s = (x.cpu().numpy() for x in solved[:3])
        for i, k in enumerate(range(base, base + Wn)):
            self.keyframes[k] = self.keyframes[k]._replace(
                R=R_s[i], t=t_s[i], v=v_s[i])


def _dummy_pre(device) -> imu_mod.Preintegrated:
    f32 = dict(dtype=torch.float32, device=device)
    z33 = torch.zeros((3, 3), **f32)
    return imu_mod.Preintegrated(
        dR=torch.eye(3, **f32), dv=torch.zeros(3, **f32),
        dp=torch.zeros(3, **f32), dt=torch.zeros((), **f32), dR_dbg=z33,
        dv_dbg=z33, dv_dba=z33, dp_dbg=z33, dp_dba=z33,
        cov=torch.eye(9, **f32) * 1e-4)
