"""Fixed-lag visual-inertial smoother: windowed batched Gauss-Newton (the
JAX package's vio/smoother.py).

Role of Kimera-VIO's back-end (GTSAM iSAM2 with IMU, between and smart
stereo factors over a 25-state horizon). The whole sliding window
re-solves at every keyframe. Landmarks are structureless: each is
re-triangulated from the current window poses inside the residual, so the
state is (pose, velocity, biases) per keyframe. The oldest state is
anchored by a prior at its running estimate (the marginalization
surrogate).

Derivatives. The JAX package runs matrix-free Gauss-Newton: each CG step
is one `jax.linearize` JVP and one `jax.vjp` of the whole residual. Here
J (N x 15 W) is written out once per Gauss-Newton iteration (`linearize`:
left rotation perturbations with the inverse right Jacobian of SO(3),
the landmarks through the triangulation's normal system, dX = A^-1 (db -
dA X)); tests/test_torch_vio_imu_smoother.py holds it against
`torch.func.jacfwd` and `jax.jacfwd` of the residual. No autodiff runs on
the path, so there is no float scatter-add and no atomic on the card:
two card runs give the same bits. Then JAX's CG (its `cg_iters` steps,
each applying J^T (J p) + damping p as JAX's JVP-then-VJP does) and its
ladder of `step_trials` damped steps on the true cost, with the same
iteration counts. The math is the JAX package's; only rounding differs
(J^T J is near singular, condition ~1e18 on the tests' window, so 30 CG
steps in float32 carry ulp differences into the step: compare solves by
cost and by millirad). At W = 25 and 300 landmarks J is about 30,600 x
375 floats (46 MB); the landmarks' derivative blocks (L, W, W, 3, 6)
about 14 MB.

Precision. The triangulation (its normal system, solve and derivatives)
runs in float64, the rest in float32. A landmark far along nearly
parallel rays (stereo ranges of hundreds of metres at the 0.25 px
disparity floor, 0.01 rad of parallax) makes the 3 x 3 system so
ill-conditioned that float32 gives X, and its rows of J, of the wrong
sign; those rows then steer the solve by their rounding: in float32, as
the JAX package computes it, robot 1 of the 6 x 60 vio-sim run at
640 x 480 ends 22 % long in JAX and stalls at zero velocity in the port;
in float64 it ends 6 % long (frames 30 - 59 on the CPU). The tests hold
the float64 triangulation to JAX's float32 one within their stated
tolerances.

The IMU factors' whitening L^-1 (L the Cholesky factor of each
preintegration covariance, which the state does not change) is formed
once per solve and applied as a 9 x 9 product; the JAX package solves
with L inside every residual evaluation. Same function, other rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..kernels.linalg import _tri_solve_unrolled, cholesky_unrolled
from . import imu as imu_mod


class VioState(NamedTuple):
    """Sliding window of W keyframe states."""

    R: torch.Tensor  # (W, 3, 3)
    t: torch.Tensor  # (W, 3)
    v: torch.Tensor  # (W, 3)
    bg: torch.Tensor  # (W, 3) gyro bias
    ba: torch.Tensor  # (W, 3) accel bias


class VioWindow(NamedTuple):
    """All measurements binding the window (fixed shapes, masked)."""

    pre: imu_mod.Preintegrated  # batched over (W-1,)
    imu_valid: torch.Tensor  # (W-1,)
    bearings: torch.Tensor  # (L, W, 3) unit bearings
    obs_valid: torch.Tensor  # (L, W)
    odo_R: torch.Tensor  # (W-1, 3, 3)
    odo_t: torch.Tensor  # (W-1, 3)
    odo_valid: torch.Tensor  # (W-1,)
    zero_vel: torch.Tensor  # (W,) bool
    anchor: VioState  # leaves with leading dim 1
    depths: torch.Tensor | None = None  # (L, W) range along the bearing
    depth_valid: torch.Tensor | None = None  # (L, W)
    depth_sigmas: torch.Tensor | None = None  # (L, W)


class VioConfig(NamedTuple):
    imu_weight: float = 1.0
    proj_sigma: float = 1e-2
    odo_rot_sigma: float = 1e-2
    odo_trans_sigma: float = 5e-2
    bias_rw_sigma: float = 1e-3
    zero_vel_sigma: float = 1e-2
    anchor_pose_sigma: float = 1e-3
    anchor_rp_sigma: float = 0.1
    anchor_vel_sigma: float = 1.0
    anchor_bias_sigma: float = 1e-2
    depth_sigma: float = 0.15
    step_trials: int = 6
    gn_iters: int = 5
    cg_iters: int = 30
    damping: float = 1e-6


def _adj_det3(A):
    """The adjugate (as rows of cofactors, C[i][j]) and determinant of
    (..., 3, 3) matrices."""
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = (
        r.unbind(-1) for r in A.unbind(-2))
    C = ((a11 * a22 - a12 * a21, a12 * a20 - a10 * a22,
          a10 * a21 - a11 * a20),
         (a02 * a21 - a01 * a22, a00 * a22 - a02 * a20,
          a01 * a20 - a00 * a21),
         (a01 * a12 - a02 * a11, a02 * a10 - a00 * a12,
          a00 * a11 - a01 * a10))
    return C, a00 * C[0][0] + a01 * C[0][1] + a02 * C[0][2]


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _rot_t(R, x):
    """R^T x for (..., 3, 3) and (..., 3)."""
    return torch.sum(R * x[..., :, None], dim=-2)


def _rot(R, x):
    """R x for (..., 3, 3) and (..., 3)."""
    return torch.sum(R * x[..., None, :], dim=-1)


def _normal_system(bearings, R, t, valid, depths=None, depth_w=None):
    """The triangulation's world rays d (L, W, 3), per-ray weights w and
    depth weights c (L, W), projectors P = w (I - d d^T) (L, W, 3, 3) and
    normal system A (L, 3, 3), b (L, 3)."""
    d = _rot(R, bearings)  # world rays (L, W, 3)
    w = valid.to(bearings.dtype)
    eye = torch.eye(3, dtype=bearings.dtype, device=bearings.device)
    P = (eye - d[..., :, None] * d[..., None, :]) * w[..., None, None]
    A = torch.sum(P, dim=-3)
    b = torch.sum(P * t[:, None, :], dim=(-3, -1))
    c = torch.zeros_like(w)
    if depths is not None:
        c = (depth_w * w) if depth_w is not None else w
        A = A + torch.sum(c, dim=-1)[..., None, None] * eye
        b = b + torch.sum(c[..., None] * (t + depths[..., None] * d),
                          dim=-2)
    return d, w, c, P, A, b


def triangulate(bearings, R, t, valid, depths=None, depth_w=None):
    """Linear midpoint triangulation of landmarks from world-frame rays,
    optionally fused with stereo range pseudo-observations; batched over
    landmarks.

    bearings (L, W, 3) camera-frame unit bearings; R, t (W, 3, 3) / (W, 3)
    camera poses (world <- cam); valid (L, W); depths, depth_w (L, W).
    Solves sum_k (I - d_k d_k^T)(X - t_k) + sum_k w_k (X - (t_k + dep_k
    d_k)) = 0 with d_k = R_k b_k, by the adjugate (the JAX package takes
    an LU solve of the same 3 x 3 system).

    Returns (X (L, 3), ok (L,)): ok False with < 2 valid rays or
    |det A| <= 1e-8."""
    _, _, _, _, A, b = _normal_system(bearings, R, t, valid, depths,
                                      depth_w)
    C, detA = _adj_det3(A)
    ok = (torch.sum(valid, dim=-1) >= 2) & (torch.abs(detA) > 1e-8)
    # X = adj(A) b / det A; where not ok, JAX solves I X = 0
    bs = b.unbind(-1)
    inv_det = 1.0 / torch.where(ok, detA, 1.0)
    X = torch.stack([(C[0][i] * bs[0] + C[1][i] * bs[1] + C[2][i] * bs[2])
                     * inv_det for i in range(3)], dim=-1)
    return torch.where(ok[..., None], X, 0.0), ok


def imu_whitener(cov: torch.Tensor) -> torch.Tensor:
    """L^-1 for the Cholesky factor L of each (..., 9, 9) preintegration
    covariance (+ 1e-10 I, as the JAX package whitens): r_w = L^-1 r."""
    eye = torch.eye(9, dtype=cov.dtype, device=cov.device)
    L = cholesky_unrolled(cov + 1e-10 * eye)
    # column j of L^-1 solves L x = e_j
    cols = _tri_solve_unrolled(L[..., None, :, :],
                               eye.expand(*cov.shape[:-2], 9, 9), lower=True)
    return cols.transpose(-1, -2)


def residuals(state: VioState, win: VioWindow, cfg: VioConfig,
              g: torch.Tensor, whiten: torch.Tensor) -> torch.Tensor:
    """Stacked whitened residual vector of the whole window, in the JAX
    package's order: IMU, bias random walks, bearings, stereo ranges (when
    the window has depths), odometry, zero velocity, anchor. `g` the
    gravity vector, `whiten` the IMU whitening (`imu_whitener`)."""
    R, t, v, bg, ba = state
    W = R.shape[0]
    parts = []
    # the rotation errors of the IMU, odometry and anchor factors, and
    # one batched log of all of them
    E_imu, r_v, r_p = imu_mod.imu_residual_parts(
        win.pre, R[:-1], t[:-1], v[:-1], R[1:], t[1:], v[1:], g)
    Rrel = R[:-1].transpose(-1, -2) @ R[1:]
    E_odo = win.odo_R.transpose(-1, -2) @ Rrel
    # world-frame (left) rotation error of state 0 against its anchor
    E_anc = R[:1] @ win.anchor.R.transpose(-1, -2)
    logs = lie.so3_log(torch.cat([E_imu, E_odo, E_anc]))
    r_R, r_odo, e_w = logs[:W - 1], logs[W - 1:-1], logs[-1]

    # ---- IMU factors -------------------------------------------------
    r_w = _rot(whiten, torch.cat([r_R, r_v, r_p], dim=-1))
    parts.append(torch.where(win.imu_valid[:, None], r_w * cfg.imu_weight,
                             0.0).reshape(-1))

    # ---- bias random walk -------------------------------------------
    mask = win.imu_valid[:, None]
    parts.append(((bg[1:] - bg[:-1]) / cfg.bias_rw_sigma * mask)
                 .reshape(-1))
    parts.append(((ba[1:] - ba[:-1]) / cfg.bias_rw_sigma * mask)
                 .reshape(-1))

    # ---- structureless landmark factors ------------------------------
    have_depth = win.depths is not None
    ovalid = win.obs_valid
    dep = win.depths if have_depth else torch.zeros_like(ovalid,
                                                         dtype=R.dtype)
    dva = win.depth_valid if have_depth else torch.zeros_like(ovalid)
    dsig = (win.depth_sigmas if win.depth_sigmas is not None
            else torch.full_like(dep, cfg.depth_sigma))
    # depth pseudo-observation weight: ratio of the bearing factor's
    # positional noise (dep * proj_sigma) to the range noise
    q = dep * cfg.proj_sigma / dsig
    dw = torch.where(dva, q * q, 0.0)
    X, ok = triangulate(_f64(win.bearings), _f64(R), _f64(t), ovalid,
                        depths=_f64(dep), depth_w=_f64(dw))
    X = X.to(R.dtype)
    pred = _rot_t(R, X[:, None, :] - t)  # cam-frame vectors (L, W, 3)
    # eps inside the sqrt: masked-out slots may have pred = 0
    norm = torch.sqrt(torch.sum(pred * pred, dim=-1, keepdim=True) + 1e-18)
    rb = _cross(pred / norm, win.bearings) / cfg.proj_sigma
    m = ovalid & ok[:, None]
    parts.append(torch.where(m[..., None], rb, 0.0).reshape(-1))
    if have_depth:
        r_dep = (norm[..., 0] - dep) / dsig
        parts.append(torch.where(dva & m, r_dep, 0.0).reshape(-1))

    # ---- external odometry between factors ---------------------------
    trel = _rot_t(R[:-1], t[1:] - t[:-1])
    r_rot = r_odo / cfg.odo_rot_sigma
    r_tr = (trel - win.odo_t) / cfg.odo_trans_sigma
    m = win.odo_valid[:, None]
    parts.append((r_rot * m).reshape(-1))
    parts.append((r_tr * m).reshape(-1))

    # ---- zero-velocity priors ---------------------------------------
    parts.append((v * win.zero_vel[:, None] / cfg.zero_vel_sigma)
                 .reshape(-1))

    # ---- anchor (marginalization surrogate) on state 0 ---------------
    # yaw (world z) is gauge -> tight, roll/pitch observable -> loose
    a = win.anchor
    parts += [e_w[2:] / cfg.anchor_pose_sigma, e_w[:2] / cfg.anchor_rp_sigma,
              (t[0] - a.t[0]) / cfg.anchor_pose_sigma,
              (v[0] - a.v[0]) / cfg.anchor_vel_sigma,
              (bg[0] - a.bg[0]) / cfg.anchor_bias_sigma,
              (ba[0] - a.ba[0]) / cfg.anchor_bias_sigma]
    return torch.cat(parts)


def _jr_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) at (..., 3): Log(Exp(phi) Exp(e)) =
    phi + Jr^-1(phi) e + O(e^2)."""
    th2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    th2s = torch.clamp(th2, min=1e-12)
    th = torch.sqrt(th2s)
    small = th2 < 1e-6
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                    1.0 / th2s - (1.0 + torch.cos(th))
                    / (2.0 * th * torch.sin(th)))
    P = lie.hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + 0.5 * P \
        + c * (P @ P)


def linearize(state: VioState, win: VioWindow, cfg: VioConfig,
              g: torch.Tensor, whiten: torch.Tensor):
    """(r, J): `residuals` at `state` and its Jacobian (N, 15 W) with
    respect to `retract`'s delta at 0 (a left rotation perturbation in the
    world frame, then additive translation, velocity and biases), each
    factor's derivative written out. The landmarks' derivatives go
    through the triangulation: X = A^-1 b, dX = A^-1 (db - dA X)."""
    R, t, v, bg, ba = state
    W = R.shape[0]
    K = W - 1
    dev, dt_ = R.device, R.dtype
    I3 = torch.eye(3, dtype=dt_, device=dev)
    z = lambda *shape: torch.zeros(shape, dtype=dt_, device=dev)
    ar, arW = torch.arange(K, device=dev), torch.arange(W, device=dev)
    r = residuals(state, win, cfg, g, whiten)

    def pair_rows(Ji, Jj):
        """Rows of factors between states k and k + 1 (K, n, 15) each ->
        (K n, W, 15)."""
        Jb = z(K, Ji.shape[1], W, 15)
        Jb[ar, :, ar] = Ji
        Jb[ar, :, ar + 1] = Jj
        return Jb.reshape(-1, W, 15)

    Rt = R.transpose(-1, -2)
    Rit, Rjt = Rt[:-1], Rt[1:]
    E_imu, _, _ = imu_mod.imu_residual_parts(
        win.pre, R[:-1], t[:-1], v[:-1], R[1:], t[1:], v[1:], g)
    E_odo = win.odo_R.transpose(-1, -2) @ Rit @ R[1:]
    E_anc = R[:1] @ win.anchor.R.transpose(-1, -2)
    logs = lie.so3_log(torch.cat([E_imu, E_odo, E_anc]))
    r_R, r_odo, e_w = logs[:K], logs[K:-1], logs[-1]
    blocks = []

    # ---- IMU factors -------------------------------------------------
    dt = win.pre.dt[:, None, None]
    u_v = v[1:] - v[:-1] - g * dt[..., 0]
    u_p = t[1:] - t[:-1] - v[:-1] * dt[..., 0] - 0.5 * g * dt[..., 0] ** 2
    JrR = _jr_inv(r_R) @ Rjt
    Ji, Jj = z(K, 9, 15), z(K, 9, 15)
    Ji[:, 0:3, 0:3], Jj[:, 0:3, 0:3] = -JrR, JrR
    Ji[:, 3:6, 0:3] = Rit @ lie.hat(u_v)
    Ji[:, 3:6, 6:9], Jj[:, 3:6, 6:9] = -Rit, Rit
    Ji[:, 6:9, 0:3] = Rit @ lie.hat(u_p)
    Ji[:, 6:9, 3:6], Jj[:, 6:9, 3:6] = -Rit, Rit
    Ji[:, 6:9, 6:9] = -Rit * dt
    keep = win.imu_valid[:, None, None]
    blocks.append(pair_rows(
        torch.where(keep, whiten @ Ji * cfg.imu_weight, 0.0),
        torch.where(keep, whiten @ Jj * cfg.imu_weight, 0.0)))

    # ---- bias random walk -------------------------------------------
    s = win.imu_valid.to(dt_)[:, None, None] / cfg.bias_rw_sigma * I3
    for cols in (slice(9, 12), slice(12, 15)):
        Ji, Jj = z(K, 3, 15), z(K, 3, 15)
        Ji[:, :, cols], Jj[:, :, cols] = -s, s
        blocks.append(pair_rows(Ji, Jj))

    # ---- structureless landmark factors ------------------------------
    have_depth = win.depths is not None
    ovalid, bear = win.obs_valid, win.bearings
    L = bear.shape[0]
    dep = win.depths if have_depth else torch.zeros_like(ovalid, dtype=dt_)
    dva = win.depth_valid if have_depth else torch.zeros_like(ovalid)
    dsig = (win.depth_sigmas if win.depth_sigmas is not None
            else torch.full_like(dep, cfg.depth_sigma))
    q = dep * cfg.proj_sigma / dsig
    dw = torch.where(dva, q * q, 0.0)
    # the triangulation in float64 (see the module docstring)
    b64, R64, t64, dep64, dw64 = map(_f64, (bear, R, t, dep, dw))
    d, w, c, P, A, _ = _normal_system(b64, R64, t64, ovalid, dep64, dw64)
    X, ok = triangulate(b64, R64, t64, ovalid, depths=dep64, depth_w=dw64)
    I3d = _f64(I3)
    C, detA = _adj_det3(A)
    inv_det = 1.0 / torch.where(ok, detA, 1.0)
    Ainv = torch.stack([torch.stack([C[j][i] for j in range(3)], -1)
                        for i in range(3)], -2) * inv_det[:, None, None]
    Ainv = torch.where(ok[:, None, None], Ainv, 0.0)
    e = X[:, None, :] - t64  # (L, W, 3)
    # dX / d(theta_m, t_m): A^-1 G_m (-[d_m]x) and A^-1 (P_m + c_m I)
    G = (w * torch.sum(d * e, dim=-1) + c * dep64)[..., None, None] \
        * I3d + w[..., None, None] * d[..., :, None] * e[..., None, :]
    DX = torch.cat([Ainv[:, None] @ G @ (-lie.hat(d)),
                    Ainv[:, None] @ (P + c[..., None, None] * I3d)],
                   dim=-1).to(dt_)
    X, e = X.to(dt_), e.to(dt_)
    # d pred_k / d(state m) = R_k^T dX/dm, plus on k = m the direct terms
    Dp = Rt[None, :, None] @ DX[:, None]  # (L, W_k, W_m, 3, 6)
    Dp[:, arW, arW] += torch.cat([Rt @ lie.hat(e), -Rt.expand(L, W, 3, 3)],
                                 dim=-1)
    pred = _rot_t(R, e)
    n = torch.sqrt(torch.sum(pred * pred, dim=-1, keepdim=True) + 1e-18)
    u = pred / n
    Nu = (I3 - u[..., :, None] * u[..., None, :]) / n[..., None]
    Jb = (-lie.hat(bear) @ Nu / cfg.proj_sigma)[:, :, None] @ Dp
    m = ovalid & ok[:, None]
    Jb = torch.where(m[:, :, None, None, None], Jb, 0.0)
    Jl = z(L, W, 3, W, 15)
    Jl[..., 0:6] = Jb.permute(0, 1, 3, 2, 4)
    blocks.append(Jl.reshape(-1, W, 15))
    if have_depth:
        Jd = (u[:, :, None, None, :] @ Dp)[..., 0, :] \
            / dsig[:, :, None, None]
        Jd = torch.where((dva & m)[:, :, None, None], Jd, 0.0)
        Jdl = z(L, W, W, 15)
        Jdl[..., 0:6] = Jd
        blocks.append(Jdl.reshape(-1, W, 15))

    # ---- external odometry between factors ---------------------------
    om = win.odo_valid.to(dt_)[:, None, None]
    JrO = _jr_inv(r_odo) @ Rjt * (om / cfg.odo_rot_sigma)
    Ji, Jj = z(K, 3, 15), z(K, 3, 15)
    Ji[:, :, 0:3], Jj[:, :, 0:3] = -JrO, JrO
    blocks.append(pair_rows(Ji, Jj))
    st = om / cfg.odo_trans_sigma
    Ji, Jj = z(K, 3, 15), z(K, 3, 15)
    Ji[:, :, 0:3] = Rit @ lie.hat(t[1:] - t[:-1]) * st
    Ji[:, :, 3:6], Jj[:, :, 3:6] = -Rit * st, Rit * st
    blocks.append(pair_rows(Ji, Jj))

    # ---- zero-velocity priors ---------------------------------------
    Jz = z(W, 3, W, 15)
    Jz[arW, :, arW, 6:9] = (win.zero_vel.to(dt_)[:, None, None]
                            / cfg.zero_vel_sigma * I3)
    blocks.append(Jz.reshape(-1, W, 15))

    # ---- anchor on state 0: Log(Exp(a) E) = e_w + Jl^-1(e_w) a --------
    Jli = _jr_inv(-e_w)
    Ja = z(15, W, 15)
    Ja[0:1, 0, 0:3] = Jli[2:] / cfg.anchor_pose_sigma
    Ja[1:3, 0, 0:3] = Jli[:2] / cfg.anchor_rp_sigma
    Ja[3:6, 0, 3:6] = I3 / cfg.anchor_pose_sigma
    Ja[6:9, 0, 6:9] = I3 / cfg.anchor_vel_sigma
    Ja[9:12, 0, 9:12] = I3 / cfg.anchor_bias_sigma
    Ja[12:15, 0, 12:15] = I3 / cfg.anchor_bias_sigma
    blocks.append(Ja)
    return r, torch.cat(blocks).reshape(-1, W * 15)


def retract(state: VioState, delta: torch.Tensor) -> VioState:
    """delta: (W, 15) = [dw, dt, dv, dbg, dba]."""
    return VioState(
        R=lie.so3_exp(delta[:, 0:3]) @ state.R,
        t=state.t + delta[:, 3:6],
        v=state.v + delta[:, 6:9],
        bg=state.bg + delta[:, 9:12],
        ba=state.ba + delta[:, 12:15],
    )


def solve_window(state0: VioState, win: VioWindow,
                 cfg: VioConfig = VioConfig()) -> VioState:
    """Gauss-Newton over the window: `gn_iters` iterations, each J written
    out (`linearize`), `cg_iters` CG steps on J^T J + damping I, and the
    best of `step_trials` halved steps, kept where it lowers the cost.
    Reads nothing back to the host."""
    W = state0.R.shape[0]
    dev = state0.R.device
    g = imu_mod.gravity(dev)
    whiten = imu_whitener(win.pre.cov)

    def full_res(delta, st):
        return residuals(retract(st, delta), win, cfg, g, whiten)

    steps = 0.5 ** torch.arange(cfg.step_trials, dtype=torch.float32,
                                device=dev)
    st = state0
    for _ in range(cfg.gn_iters):
        r0, J = linearize(st, win, cfg, g, whiten)
        grad = J.T @ r0

        x = torch.zeros_like(grad)
        r, p = -grad, -grad
        rs = torch.sum(grad * grad)
        for _ in range(cfg.cg_iters):
            Ap = J.T @ (J @ p) + cfg.damping * p
            alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            rs2 = torch.sum(r * r)
            p = r + (rs2 / torch.clamp(rs, min=1e-20)) * p
            rs = rs2
        # damped accept: the best improving point of a fixed backtracking
        # ladder on the true cost (non-finite trial costs lose the argmin)
        delta = torch.nan_to_num(x).reshape(W, 15)

        def trial_cost(s):
            res = full_res(s * delta, st)
            c = torch.sum(res * res)
            return torch.where(torch.isfinite(c), c, torch.inf)

        costs = torch.func.vmap(trial_cost)(steps)
        c0 = torch.sum(r0 * r0)
        best = torch.argmin(costs)
        improved = costs[best] < c0
        st_new = retract(st, steps[best] * delta)
        st = VioState(*(torch.where(improved, a, b)
                        for a, b in zip(st_new, st)))
    return st
