"""The port's renderer, descriptors, 1-point stereo RANSAC, VIO config
import and the whole `VioPipeline` against the JAX package's on the CPU.

The pipeline runs the vio-sim run's configuration (cli/run.py) at a tiny
size: 6 rendered stereo frames of 96 x 72, 48 features, a window of 3,
every frame a keyframe. The same frames and IMU go into both pipelines
(frames rendered by the port).

Tolerances: rendered images within 1e-5 of their largest pixel
(products summed in another order); the trajectory and IMU arrays equal;
descriptors equal on >= 99 % of the bits; the 1-point RANSAC with the same
key: the same inliers and gate, translation within 1e-5; the config
equal field by field. The pipeline: the same number of keyframes and of
correspondences at each, inlier counts within 2, the first two
keyframes' tracks equal (positions within 1e-3 px), every keyframe's final
position within 2e-3 m and rotation within 2e-3 of JAX's, velocity
within 1e-2 m/s (the smoother's CG on a near-singular J^T J turns ulp
differences into these, and the port triangulates in float64,
tests/test_torch_vio_imu_smoother.py; 5.0e-4, 8.9e-4 and 3.5e-3 on the
CPU)."""

import jax
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import rng as jrng
from kimera_multi_tpu.io import render as jrender
from kimera_multi_tpu.kernels import ransac as jransac
from kimera_multi_tpu.vio import descriptors as jdesc, pipeline as jpipe
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import rng
from kimera_multi_tpu_torch.io import render
from kimera_multi_tpu_torch.kernels import ransac
from kimera_multi_tpu_torch.vio import descriptors, pipeline
from kimera_multi_tpu_torch.vio.undistort import CameraModel

torch.set_num_threads(1)

W, H, FEATS, WIN, FRAMES = 96, 72, 48, 3, 6
CAM = CameraModel(fx=0.86 * W, fy=0.86 * W, cx=W / 2, cy=H / 2)


@pytest.fixture(scope="module")
def seq():
    rig = render.StereoRig(cam=CAM, H=H, W=W, baseline=0.2)
    return render.render_sequence(
        render.make_scene(0, 350), rig, n_frames=FRAMES, rate_hz=10.0,
        imu_rate_hz=100.0, speed=0.6, yaw_rate=0.1, device="cpu")


def test_render_matches_jax(seq):
    jcam = jpipe.CameraModel(*CAM)
    jrig = jrender.StereoRig(cam=jcam, H=H, W=W, baseline=0.2)
    ref = jrender.render_sequence(
        jrender.make_scene(0, 350), jrig, n_frames=2, rate_hz=10.0,
        imu_rate_hz=100.0, speed=0.6, yaw_rate=0.1)
    for f in ("timestamps", "R_gt", "t_gt", "imu_ts", "gyro", "accel"):
        a, b = getattr(seq, f), getattr(ref, f)
        np.testing.assert_array_equal(a[:len(b)], b, err_msg=f)
    for f in ("left", "right"):
        a, b = getattr(seq, f)[:2], getattr(ref, f)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f
    # with radtan distortion, one frame through render() itself
    dcam = CAM._replace(k1=-0.1, k2=0.02, p1=1e-3, p2=-1e-3)
    sc = render.make_scene(1, 200)
    a = render.render(*(torch.from_numpy(x) for x in (
        sc.points, sc.intensity, seq.R_gt[1], seq.t_gt[1])), dcam, H, W,
        1.6, True).numpy()
    b = np.asarray(jrender.render(
        sc.points, sc.intensity, seq.R_gt[1], seq.t_gt[1],
        jpipe.CameraModel(*dcam), H, W, 1.6, True))
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_describe_matches_jax(seq):
    img = seq.left[2]
    rs = np.random.default_rng(4)
    pts = np.stack([rs.uniform(-3, W + 3, 64), rs.uniform(-3, H + 3, 64)],
                   -1).astype(np.float32)
    valid = rs.uniform(size=64) < 0.9
    ref = np.asarray(jax.jit(jdesc.describe)(img, pts, valid))
    got = descriptors.describe(torch.from_numpy(img), torch.from_numpy(pts),
                               torch.from_numpy(valid)).numpy()
    assert got.dtype == np.uint8 and got.shape == (64, 32)
    assert (got[~valid] == 0).all()
    same = np.unpackbits(got) == np.unpackbits(ref)
    assert same.mean() >= 0.99


def test_ransac_translation_known_rotation_matches_jax():
    rs = np.random.default_rng(5)
    K = 60
    p = rs.uniform(-3, 3, (3, K)).astype(np.float32)
    Rs = jrender.circular_trajectory(3)[1]
    R = Rs[1] @ Rs[2].T
    q = (R @ p + np.asarray([[0.3], [-0.1], [0.05]])
         + rs.normal(0, 0.01, (3, K))).astype(np.float32)
    q[:, :12] += rs.uniform(1, 2, (3, 12)).astype(np.float32)  # outliers
    valid = rs.uniform(size=K) < 0.9
    key = jrng.derive(jrng.base_key(3), jrng.Stream.RANSAC_STEREO)
    ref = jax.jit(lambda k, a, b, r, v: jransac
                  .ransac_translation_known_rotation(
                      k, a, b, r, v, threshold=0.05, min_inliers=5))(
        key, p, q, R, valid)
    tkey = rng.derive(rng.base_key(3), rng.Stream.RANSAC_STEREO)
    got = ransac.ransac_translation_known_rotation(
        tkey[None], torch.from_numpy(p)[None], torch.from_numpy(q)[None],
        torch.from_numpy(R)[None], torch.from_numpy(valid)[None],
        threshold=0.05, min_inliers=5)
    idx = np.asarray(jransac._masked_sample(key, valid, 200, 1))
    tidx = ransac._masked_sample(tkey[None], torch.from_numpy(valid)[None],
                                 200, 1)[0].numpy()
    np.testing.assert_array_equal(tidx, idx)
    np.testing.assert_array_equal(got["inliers"][0].numpy(),
                                  np.asarray(ref["inliers"]))
    assert int(got["n_inliers"][0]) == int(ref["n_inliers"]) >= 40
    assert bool(got["ok"][0]) == bool(ref["ok"])
    np.testing.assert_allclose(got["t"][0].numpy(), np.asarray(ref["t"]),
                               rtol=0, atol=1e-5)


def test_config_from_params_folder(tmp_path):
    (tmp_path / "LeftCameraParams.yaml").write_text(
        "%YAML:1.0\n# left camera\nintrinsics: [381.5, 380.25, 320.5, "
        "239.75]\ndistortion_model: radtan\ndistortion_coefficients: "
        "[-0.05, 0.01,\n  0.001, -0.002]\n")
    (tmp_path / "FrontendParams.yaml").write_text(
        "%YAML:1.0\nklt_win_size: 21\nklt_max_iter: 25\nklt_max_level: 3\n"
        "klt_eps: 0.05\nmaxFeaturesPerFrame: 250\nquality_level: 0.002\n"
        "min_distance: 15\nmin_intra_keyframe_time: 0.3\n"
        "disparityThreshold: 0.75\nransac_threshold_mono: 2e-6\n"
        "ransac_max_iterations: 300\nransac_use_1point_stereo: 1\n")
    (tmp_path / "BackendParams.yaml").write_text(
        "%YAML:1.0\nnr_states: 20\n")
    ref = jpipe.PipelineConfig.from_params_folder(str(tmp_path),
                                                  base_seed=4)
    got = pipeline.PipelineConfig.from_params_folder(str(tmp_path),
                                                     base_seed=4)
    assert got == convert.vio_config_from_jax(ref)
    assert got.cam.fx == 381.5 and got.cam.p2 == -0.002
    assert got.window_size == 20 and got.ransac_use_1point_stereo


def _vio_config():
    """The vio-sim run's configuration at this width (cli/run.py)."""
    return jpipe.PipelineConfig(
        cam=jpipe.CameraModel(*CAM), baseline=0.2, window_size=WIN,
        max_features=FEATS,
        gftt=jpipe.tracking.GfttParams(max_features=FEATS,
                                       min_distance=max(6, W // 21),
                                       quality_level=0.001),
        klt=jpipe.tracking.KltParams(win_size=12, max_level=3, max_iter=20),
        min_intra_keyframe_time=0.0, disparity_threshold=0.0,
        ransac_iterations=200, min_mono_inliers=8, min_stereo_inliers=4,
        vio=jpipe.smoother.VioConfig(gn_iters=12),
        imu=jpipe.imu_mod.ImuParams(gyro_noise=2e-3, accel_noise=2e-2))


def _drive(vio, seq):
    i = 0
    for k in range(FRAMES):
        ts = seq.timestamps[k]
        while i < len(seq.imu_ts) and seq.imu_ts[i] <= ts:
            vio.add_imu(seq.imu_ts[i], seq.gyro[i], seq.accel[i])
            i += 1
        vio.process_frame(ts, seq.left[k], seq.right[k])
    return convert.keyframes_to_numpy(vio.keyframes), vio.rejection_log


def test_vio_pipeline_matches_jax(seq):
    jcfg = _vio_config()
    ref, ref_log = _drive(jpipe.VioPipeline(jcfg), seq)
    got, got_log = _drive(pipeline.VioPipeline(
        convert.vio_config_from_jax(jcfg), device="cpu"), seq)
    assert len(got_log) == len(ref_log) == FRAMES
    for a, b in zip(got_log, ref_log):
        assert a.n_corresp == b.n_corresp
        assert abs(a.mono_inliers - b.mono_inliers) <= 2
        assert abs(a.stereo_inliers - b.stereo_inliers) <= 2
    assert min(s.n_corresp for s in ref_log[1:]) >= 8
    np.testing.assert_array_equal(got["timestamp"], ref["timestamp"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=1e-2)
    # the features of the first keyframes: same detections and tracks
    for f in ("track_ids", "valid"):
        np.testing.assert_array_equal(got[f][:2], ref[f][:2], err_msg=f)
    np.testing.assert_allclose(got["pts"][:2], ref["pts"][:2], rtol=0,
                               atol=1e-3)
    # and it moved: 0.06 m a frame along the arc
    assert np.linalg.norm(ref["t"][-1] - ref["t"][0]) > 0.2
