"""The port's IMU preintegration and fixed-lag smoother
(`kimera_multi_tpu_torch.vio.imu` / `vio.smoother`) against the JAX
package's on the CPU, on a synthetic window: W = 4 keyframes 0.1 s apart
on an arc, 24 landmarks 4 - 8 m ahead seen with bearing noise, stereo
ranges, one odometry factor, the IMU of the arc preintegrated between
keyframes. Each JAX function is compiled once per module.

Tolerances: preintegration within 1e-5 of each field's largest entry
(entries that cancel to 1e-3 of it carry relative rounding), and padding
steps are exact no-ops (the integrated prefix equals the 128-step padded
window, bit for bit); the IMU residual within 1e-5; triangulation within
1e-4 relative where |det A| is away from its 1e-8 gate, `ok` equal there; the whole residual
vector within 1e-3 relative to its largest entry (the port whitens with
L^-1, JAX by substitution); `solve_window`: its written-out J
(`linearize`) equal to `torch.func.jacfwd`'s and `jax.jacfwd`'s of the
residual to 1e-6 of J's largest entry; after one Gauss-Newton iteration
poses and velocities within 1e-3 of JAX's and the cost within 1 %; after
the default 5, both lower the cost more than 1000-fold, the port's at
most 2 % above JAX's, rotations within 5e-2, translations within 1e-2 and
velocities within 5e-2 (J^T J has condition ~1e18 on this window: 30
float32 CG steps a Gauss-Newton iteration carry ulp differences of J into
the step along its flat directions, and the port triangulates in
float64: on the CPU the two end 0.017 rad apart); forward-mode derivatives
of so3_exp at 0 and so3_log at I finite and within 1e-6 of
`jax.jvp`'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import lie as jlie
from kimera_multi_tpu.vio import imu as jimu, smoother as jsm
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.core import lie
from kimera_multi_tpu_torch.vio import imu, smoother

torch.set_num_threads(1)

Wn, L, S = 4, 24, 128


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def _imu_window(rs, n):
    """n filled samples of an arc (gyro about -y, specific force with
    gravity), padded to S."""
    gyro = np.zeros((S, 3), np.float32)
    accel = np.zeros((S, 3), np.float32)
    dts = np.zeros(S, np.float32)
    gyro[:n] = [0.0, -0.3, 0.0] + rs.normal(0, 1e-3, (n, 3))
    accel[:n] = [0.05, -9.81, 0.2] + rs.normal(0, 1e-2, (n, 3))
    dts[:n] = 0.01
    dts[n // 2] = 0.0  # a repeated timestamp inside the window
    return gyro, accel, dts


@pytest.fixture(scope="module")
def jax_pre():
    return jax.jit(jimu.preintegrate)


def test_preintegrate_matches_jax(jax_pre):
    rs = np.random.default_rng(0)
    gyro, accel, dts = _imu_window(rs, 11)
    bg = np.asarray([1e-3, -2e-3, 5e-4], np.float32)
    ba = np.asarray([0.02, 0.01, -0.03], np.float32)
    ref = jax_pre(gyro, accel, dts, bg, ba, jimu.ImuParams())
    t = lambda a: torch.from_numpy(a)
    got = imu.preintegrate(t(gyro), t(accel), t(dts), t(bg), t(ba))
    for f in imu.Preintegrated._fields:
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=f)
    # the JAX package pads to S samples; the pipeline integrates only the
    # filled ones: padding steps keep the carry exactly
    head = imu.preintegrate(t(gyro[:11]), t(accel[:11]), t(dts[:11]),
                            t(bg), t(ba))
    for a, b in zip(head, got):
        assert torch.equal(a, b)


def _window(jax_pre):
    """A synthetic window (numpy): true states, noisy initial states and
    the measurements binding them."""
    rs = np.random.default_rng(1)
    R_true = np.stack([_rot([0.0, -0.03 * k, 0.0]) for k in range(Wn)])
    t_true = np.stack([[0.06 * k, 0.0, 0.0015 * k * k]
                       for k in range(Wn)]).astype(np.float32)
    v_true = np.tile(np.asarray([0.6, 0.0, 0.03], np.float32), (Wn, 1))
    X = np.stack([rs.uniform(-2, 2, L), rs.uniform(-1, 1, L),
                  rs.uniform(4, 8, L)], -1).astype(np.float32)
    cam = np.einsum("kji,lkj->lki", R_true, X[:, None] - t_true[None])
    rng_true = np.linalg.norm(cam, axis=-1)
    bear = cam / rng_true[..., None] + rs.normal(0, 2e-3, cam.shape)
    bear = (bear / np.linalg.norm(bear, axis=-1, keepdims=True)).astype(
        np.float32)
    obs = rs.uniform(size=(L, Wn)) < 0.9
    obs[:2, 1:] = False  # two landmarks seen once: not triangulable
    pres = [jax_pre(*_imu_window(rs, 10), np.zeros(3, np.float32),
                    np.zeros(3, np.float32), jimu.ImuParams())
            for _ in range(Wn - 1)]
    pre = {f: np.stack([np.asarray(getattr(p, f)) for p in pres])
           for f in jimu.Preintegrated._fields}
    odo_R = np.tile(np.eye(3, dtype=np.float32), (Wn - 1, 1, 1))
    odo_R[1] = R_true[1].T @ R_true[2]
    odo_t = np.zeros((Wn - 1, 3), np.float32)
    odo_t[1] = R_true[1].T @ (t_true[2] - t_true[1])
    perturb = [_rot(rs.normal(0, 0.01, 3)) for _ in range(Wn)]
    state0 = dict(
        R=np.stack([p @ r for p, r in zip(perturb, R_true)]).astype(
            np.float32),
        t=(t_true + rs.normal(0, 0.02, t_true.shape)).astype(np.float32),
        v=(v_true + rs.normal(0, 0.05, v_true.shape)).astype(np.float32),
        bg=np.zeros((Wn, 3), np.float32), ba=np.zeros((Wn, 3), np.float32))
    state0["R"][0], state0["t"][0] = R_true[0], t_true[0]
    win = dict(
        pre=pre, imu_valid=np.asarray([True, False, True]), bearings=bear,
        obs_valid=obs, odo_R=odo_R, odo_t=odo_t,
        odo_valid=np.asarray([False, True, False]),
        zero_vel=np.zeros(Wn, bool),
        anchor={k: v[:1] for k, v in state0.items()},
        depths=(rng_true * (1 + rs.normal(0, 0.01, rng_true.shape))).astype(
            np.float32),
        depth_valid=obs & (rs.uniform(size=(L, Wn)) < 0.8),
        depth_sigmas=np.full((L, Wn), 0.15, np.float32))
    return state0, win


def _jax_window(win):
    return jsm.VioWindow(
        pre=jimu.Preintegrated(**{k: jnp.asarray(v)
                                  for k, v in win["pre"].items()}),
        anchor=jsm.VioState(**{k: jnp.asarray(v)
                               for k, v in win["anchor"].items()}),
        **{k: jnp.asarray(v) for k, v in win.items()
           if k not in ("pre", "anchor")})


@pytest.fixture(scope="module")
def window(jax_pre):
    state0, win = _window(jax_pre)
    jstate = jsm.VioState(**{k: jnp.asarray(v) for k, v in state0.items()})
    tstate = convert.vio_state_from_numpy(**state0, device="cpu")
    twin = convert.vio_window_from_numpy(device="cpu", **win)
    return jstate, _jax_window(win), tstate, twin


def test_imu_residual_matches_jax(window):
    js, jw, ts, tw = window
    ref = jax.vmap(lambda p, i: jimu.imu_residual(
        p, js.R[i], js.t[i], js.v[i], js.bg[i], js.ba[i], js.R[i + 1],
        js.t[i + 1], js.v[i + 1]))(jw.pre, jnp.arange(Wn - 1))
    got = imu.imu_residual(tw.pre, ts.R[:-1], ts.t[:-1], ts.v[:-1],
                           ts.bg[:-1], ts.ba[:-1], ts.R[1:], ts.t[1:],
                           ts.v[1:], imu.gravity())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_triangulate_matches_jax(window):
    js, jw, ts, tw = window
    dw = np.where(np.asarray(jw.depth_valid), 0.3, 0.0).astype(np.float32)
    jX, jok = jax.jit(jax.vmap(jsm.triangulate,
                               in_axes=(0, None, None, 0, 0, 0)))(
        jw.bearings, js.R, js.t, jw.obs_valid, jw.depths, dw)
    det = np.asarray(jax.vmap(lambda b, v, dd: jnp.linalg.det(
        jnp.sum((jnp.eye(3) - jnp.einsum("kij,kj->ki", js.R, b)[:, :, None]
                 * jnp.einsum("kij,kj->ki", js.R, b)[:, None, :])
                * v[:, None, None], 0) + jnp.sum(dd * v) * jnp.eye(3)))(
        jw.bearings, jw.obs_valid, dw))
    tX, tok = smoother.triangulate(tw.bearings, ts.R, ts.t, tw.obs_valid,
                                   tw.depths, torch.from_numpy(dw))
    away = (np.abs(np.abs(det) - 1e-8) > 1e-9)
    assert (~np.asarray(jok)).sum() >= 2 and away.all()
    np.testing.assert_array_equal(tok.numpy()[away], np.asarray(jok)[away])
    ok = np.asarray(jok)
    np.testing.assert_allclose(tX.numpy()[ok], np.asarray(jX)[ok], rtol=1e-4,
                               atol=1e-5)


def _cost(r):
    return float(np.sum(np.asarray(r, np.float64) ** 2))


def test_residuals_match_jax(window):
    js, jw, ts, tw = window
    cfg = jsm.VioConfig()
    ref = np.asarray(jax.jit(lambda s, w: jsm.residuals(s, w, cfg))(js, jw))
    got = smoother.residuals(ts, tw, smoother.VioConfig(), imu.gravity(),
                             smoother.imu_whitener(tw.pre.cov)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_solve_window_matches_jax(window):
    js, jw, ts, tw = window
    cfg = jsm.VioConfig()
    # the linearization: the written-out J against forward-mode autodiff
    # of the residual, the port's and JAX's
    full = lambda d: jsm.residuals(jsm.retract(js, d), jw, cfg)
    Jj = np.asarray(jax.jit(jax.jacfwd(full))(
        jnp.zeros((Wn, 15)))).reshape(-1, Wn * 15)
    g, wh = imu.gravity(), smoother.imu_whitener(tw.pre.cov)
    tcfg = smoother.VioConfig()
    Jf, r0 = torch.func.jacfwd(lambda d: (smoother.residuals(
        smoother.retract(ts, d), tw, tcfg, g, wh),) * 2,
        has_aux=True)(torch.zeros((Wn, 15)))
    r, J = smoother.linearize(ts, tw, tcfg, g, wh)
    assert torch.equal(r, r0) and J.dtype == torch.float32
    for ref in (Jf.reshape(-1, Wn * 15).numpy(), Jj):
        assert np.abs(J.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    res = jax.jit(lambda s, w: jsm.residuals(s, w, cfg))
    c0 = _cost(res(js, jw))
    # one Gauss-Newton iteration: the same step (an iteration reads only
    # the state and the window, so 5 of them are 5 calls of one)
    c1 = cfg._replace(gn_iters=1)
    gn1 = jax.jit(lambda s, w: jsm.solve_window(s, w, c1))
    ref = gn1(js, jw)
    got = smoother.solve_window(ts, tw, tcfg._replace(gn_iters=1))
    for f in ("R", "t", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-3, err_msg=f)
    cj = _cost(res(ref, jw))
    ct = _cost(res(jsm.VioState(*(jnp.asarray(x.numpy()) for x in got)),
                   jw))
    assert cj < 0.1 * c0 and abs(ct - cj) <= 0.01 * cj
    # the default 5 iterations: both converge, the port no higher
    for _ in range(cfg.gn_iters - 1):
        ref = gn1(ref, jw)
    got = smoother.solve_window(ts, tw, tcfg)
    cj = _cost(res(ref, jw))
    ct = _cost(res(jsm.VioState(*(jnp.asarray(x.numpy()) for x in got)),
                   jw))
    assert cj < 1e-3 * c0 and ct <= 1.02 * cj
    for f, tol in (("R", 5e-2), ("t", 1e-2), ("v", 5e-2)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=tol, err_msg=f)
    # no IMU bias enters this window's IMU factors: biases stay at 0
    assert not got.bg.any() and not got.ba.any()


def test_lie_forward_derivatives_at_zero_match_jax():
    """retract at delta = 0 and the anchor / odometry logs at the identity
    are where the smoother differentiates: finite there and equal to
    JAX's."""
    # batches of one, as the smoother evaluates them (on a 0-dim batch
    # torch gives a Python float's sum a float64 tangent)
    v = np.asarray([[0.3, -0.2, 0.5]], np.float32)
    _, jd = jax.jvp(jlie.so3_exp, (jnp.zeros((1, 3)),), (jnp.asarray(v),))
    _, td = torch.func.jvp(lie.so3_exp, (torch.zeros((1, 3)),),
                           (torch.tensor(v),))
    V = np.asarray(jlie.hat(jnp.asarray(v)))
    _, jl = jax.jvp(jlie.so3_log, (jnp.eye(3)[None],), (jnp.asarray(V),))
    _, tl = torch.func.jvp(lie.so3_log, (torch.eye(3)[None],),
                           (torch.tensor(V),))
    for a, b in ((td, jd), (tl, jl)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    J = torch.func.jacfwd(lambda d: lie.so3_log(lie.so3_exp(d)))(
        torch.zeros((1, 3)))
    assert J.dtype == torch.float32 and torch.isfinite(J).all()
    assert torch.allclose(J[0, :, 0], torch.eye(3))
