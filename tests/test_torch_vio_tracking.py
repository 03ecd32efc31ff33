"""The port's bilinear sampler, undistortion, gradients, GFTT, pyramid and
KLT (`kimera_multi_tpu_torch.vio._sample` / `vio.undistort` /
`vio.tracking`) against the JAX package's
(`jax.scipy.ndimage.map_coordinates`, `vio/undistort.py`,
`vio/tracking.py`) on the CPU, on a stereo pair rendered by the port
(128 x 96, the vio-sim run's default width) and on random images. Each
JAX function is compiled once per module.

Tolerances: samples and gradients within 1e-6 absolute (pixel values are
O(1); the convolutions sum in another order); the undistortion grid and
points within 1e-4 px, the remapped image within 1e-5; GFTT the same corners, their
scores within 1e-5 relative; pyramid levels within 1e-6; KLT tracked
flags equal on >= 99 % of the features, positions within 1e-3 px where
both track."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates as jmap

from kimera_multi_tpu.vio import tracking as jtr, undistort as jund
from kimera_multi_tpu_torch.io import render
from kimera_multi_tpu_torch.vio import _sample, tracking as tr, undistort
from kimera_multi_tpu_torch.vio.undistort import CameraModel

torch.set_num_threads(1)

# the vio-sim run's parameters at its default width (cli/run.py)
W, H, FEATS = 128, 96, 96
GFTT = dict(max_features=FEATS, min_distance=max(6, W // 21),
            quality_level=0.001)
KLT = dict(win_size=12, max_level=3, max_iter=20)


@pytest.fixture(scope="module")
def frames():
    cam = CameraModel(fx=0.86 * W, fy=0.86 * W, cx=W / 2, cy=H / 2)
    rig = render.StereoRig(cam=cam, H=H, W=W, baseline=0.2)
    seq = render.render_sequence(render.make_scene(0, 400), rig, n_frames=2,
                                 rate_hz=10.0, imu_rate_hz=100.0, speed=0.6,
                                 yaw_rate=0.1, device="cpu")
    return seq.left[0], seq.left[1], seq.right[0]


@pytest.mark.parametrize("mode", ["constant", "nearest"])
def test_map_coordinates_matches_jax(mode):
    rs = np.random.default_rng(3)
    img = rs.uniform(0, 1, (9, 7)).astype(np.float32)
    # coordinates inside, on and beyond the borders (corners out of range)
    ys = rs.uniform(-2.5, 10.5, (40, 5)).astype(np.float32)
    xs = rs.uniform(-2.5, 8.5, (40, 5)).astype(np.float32)
    ys[:4], xs[:4] = np.round(ys[:4]), np.round(xs[:4])
    ref = np.asarray(jax.jit(functools.partial(
        jmap, order=1, mode=mode, cval=0.0))(img, [ys, xs]))
    got = _sample.map_coordinates(torch.from_numpy(img),
                                  torch.from_numpy(ys),
                                  torch.from_numpy(xs), mode=mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if mode == "constant":
        far = (ys < -1) | (ys > 9) | (xs < -1) | (xs > 7)
        assert far.any() and (got[far] == 0).all()


def test_undistort_matches_jax(frames):
    """A radtan camera (the D455 left camera's order of magnitude): the
    remap grid, the remapped image and undistorted points."""
    cam = CameraModel(fx=110.0, fy=109.0, cx=63.5, cy=48.2, k1=-0.08,
                      k2=0.02, p1=1e-3, p2=-5e-4)
    jcam = jund.CameraModel(*cam)
    ju, jv = jund.undistort_map(jcam, H, W)
    tu, tv = undistort.undistort_map(cam, H, W)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    ref = np.asarray(jund.remap(jnp.asarray(frames[0]), ju, jv))
    got = undistort.remap(torch.from_numpy(frames[0]), tu, tv).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    pts = np.random.default_rng(6).uniform([0, 0], [W, H], (50, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        undistort.undistort_points(torch.from_numpy(pts), cam).numpy(),
        np.asarray(jax.jit(lambda p: jund.undistort_points(p, jcam))(pts)),
        rtol=0, atol=1e-4)


def test_gradients_and_pyramid_match_jax(frames):
    img = frames[0]
    jx, jy = jax.jit(jtr.gradients)(jnp.asarray(img))
    tx, ty = tr.gradients(torch.from_numpy(img))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    # odd sizes crop to even before pooling
    odd = img[:95, :127]
    jp = jtr.build_pyramid(jnp.asarray(odd), 4)
    tp = tr.build_pyramid(torch.from_numpy(odd), 4)
    assert [p.shape for p in tp] == [(95, 127), (47, 63), (23, 31), (11, 15)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def _gftt(img):
    p = jtr.GfttParams(**GFTT)
    jp, js, jv = jax.jit(lambda i: jtr.gftt_detect(i, p))(jnp.asarray(img))
    tp, ts, tv = tr.gftt_detect(torch.from_numpy(img), tr.GfttParams(**GFTT))
    return (np.asarray(jp), np.asarray(js), np.asarray(jv),
            tp.numpy(), ts.numpy(), tv.numpy())


def test_gftt_detect_matches_jax(frames):
    jp, js, jv, tp, ts, tv = _gftt(frames[0])
    assert jv.sum() >= 20
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tp[tv], jp[jv])
    np.testing.assert_allclose(ts[tv], js[jv], rtol=1e-5)
    # the invalid slots are filled with the same zero-score pixels
    np.testing.assert_array_equal(tp, jp)


def test_klt_track_matches_jax(frames):
    i0, i1, r0 = frames
    jp, _, jv, _, _, _ = (np.array(x) for x in _gftt(i0))
    p = jtr.KltParams(**KLT)
    klt = jax.jit(lambda a, b, q, v: jtr.klt_track(a, b, q, v, p))
    for dst in (i1, r0):  # temporal and stereo tracking
        jq, jt = (np.asarray(x) for x in klt(jnp.asarray(i0),
                                             jnp.asarray(dst),
                                             jnp.asarray(jp),
                                             jnp.asarray(jv)))
        tq, tt = tr.klt_track(torch.from_numpy(i0), torch.from_numpy(dst),
                              torch.from_numpy(jp), torch.from_numpy(jv),
                              tr.KltParams(**KLT))
        tq, tt = tq.numpy(), tt.numpy()
        assert jt.sum() >= 20
        assert (tt == jt).mean() >= 0.99
        both = tt & jt
        assert np.abs(tq[both] - jq[both]).max() < 1e-3
