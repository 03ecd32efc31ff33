"""On-manifold IMU preintegration (Forster et al.), the JAX package's
vio/imu.py.

Role of Kimera-VIO's `ImuFrontend::preintegrateImuMeasurements` and
GTSAM's CombinedImuFactor. One window's samples (S, 3) gyro / accel with
intervals (S,) -> rotation, velocity and position deltas, bias Jacobians
and the 9 x 9 covariance of (rot, vel, pos). The JAX package's `lax.scan`
over the S samples is a Python loop over the same steps; a step whose
interval is not positive (padding) keeps the carry, element for element,
through `torch.where`, so a caller may leave trailing padding out and get
the same bits (tests/test_torch_vio_imu_smoother.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie

GRAVITY = (0.0, 0.0, -9.81)


def gravity(device="cpu") -> torch.Tensor:
    """The world gravity vector (3,) float32 on `device`."""
    return torch.tensor(GRAVITY, dtype=torch.float32, device=device)


class ImuParams(NamedTuple):
    gyro_noise: float = 1.7e-4  # rad/s/sqrt(Hz)
    accel_noise: float = 2.0e-3  # m/s^2/sqrt(Hz)
    gyro_bias_noise: float = 1.9e-5
    accel_bias_noise: float = 3.0e-3
    integration_noise: float = 1e-8


class Preintegrated(NamedTuple):
    dR: torch.Tensor  # (..., 3, 3) rotation delta (body_i -> body_j)
    dv: torch.Tensor  # (..., 3) velocity delta in frame i
    dp: torch.Tensor  # (..., 3) position delta in frame i
    dt: torch.Tensor  # (...,) total time
    dR_dbg: torch.Tensor  # (..., 3, 3) first-order bias Jacobians
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    cov: torch.Tensor  # (..., 9, 9)


def stack_pre(pres) -> Preintegrated:
    """A list of single-window results -> one batched over a leading
    axis."""
    return Preintegrated(*(torch.stack(x) for x in zip(*pres)))


def preintegrate(gyro: torch.Tensor, accel: torch.Tensor, dts: torch.Tensor,
                 bias_gyro: torch.Tensor, bias_accel: torch.Tensor,
                 params: ImuParams = ImuParams()) -> Preintegrated:
    """Single-window preintegration: gyro, accel (S, 3), dts (S,) sample
    intervals (0 = padding), biases (3,)."""
    dev = gyro.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    z33 = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    # noise densities^2 per axis (gyro, accel): the diagonal of Q * dt
    q = torch.tensor([params.gyro_noise ** 2] * 3
                     + [params.accel_noise ** 2] * 3, dtype=torch.float32,
                     device=dev)
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    carry = (eye, z3, z3, torch.zeros((), dtype=torch.float32, device=dev),
             z33, z33, z33, z33, z33,
             torch.zeros((9, 9), dtype=torch.float32, device=dev))
    for i in range(gyro.shape[0]):
        dR, dv, dp, T, dRg, dvg, dva, dpg, dpa, cov = carry
        valid = dts[i] > 0
        dt = torch.where(valid, dts[i], 0.0)
        w_c = gyro[i] - bias_gyro
        a_c = accel[i] - bias_accel
        wdt = w_c * dt
        dR_inc = lie.so3_exp(wdt)
        a_rot = dR @ a_c
        Ha = lie.hat(a_c)
        dRHa = dR @ Ha

        # covariance propagation (Forster eq. A.8-A.10 structure), state
        # error (dphi, dv, dp)
        A = torch.cat([
            torch.cat([dR_inc.T, z33, z33], dim=1),
            torch.cat([-dRHa * dt, eye, z33], dim=1),
            torch.cat([(-0.5 * dR) @ Ha * dt * dt, eye * dt, eye], dim=1),
        ])
        z36 = torch.zeros((3, 3), dtype=torch.float32, device=dev)
        B = torch.cat([
            torch.cat([eye * dt, z36], dim=1),
            torch.cat([z36, dR * dt], dim=1),
            torch.cat([z36, 0.5 * dR * dt * dt], dim=1),
        ])
        Q = torch.diag(q) / torch.clamp(dt, min=1e-6)
        cov_new = A @ cov @ A.T + B @ Q @ B.T
        cov_new = cov_new + params.integration_noise * torch.eye(
            9, dtype=torch.float32, device=dev)

        # bias Jacobians (first order)
        dpa_new = dpa + dva * dt - (0.5 * dR) @ eye * dt * dt
        dpg_new = dpg + dvg * dt - (0.5 * dR) @ Ha @ dRg * dt * dt
        dva_new = dva - dR * dt
        dvg_new = dvg - dRHa @ dRg * dt
        dRg_new = dR_inc.T @ dRg - _right_jacobian(wdt) * dt

        dp_new = dp + dv * dt + 0.5 * a_rot * dt * dt
        dv_new = dv + a_rot * dt
        dR_new = dR @ dR_inc
        T_new = T + dt
        carry = tuple(
            torch.where(valid, n, o) for n, o in zip(
                (dR_new, dv_new, dp_new, T_new, dRg_new, dvg_new, dva_new,
                 dpg_new, dpa_new, cov_new), carry))
    dR, dv, dp, T, dRg, dvg, dva, dpg, dpa, cov = carry
    return Preintegrated(dR=dR, dv=dv, dp=dp, dt=T, dR_dbg=dRg, dv_dbg=dvg,
                         dv_dba=dva, dp_dbg=dpg, dp_dba=dpa, cov=cov)


def _right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(w) of (..., 3)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta2s = torch.clamp(theta2, min=1e-8)
    theta = torch.sqrt(theta2s)
    W = lie.hat(w)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2s)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2s * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - a * W + b * (W @ W)


def imu_residual_parts(pre: Preintegrated, R_i, t_i, v_i, R_j, t_j, v_j,
                       g: torch.Tensor):
    """`imu_residual` before the rotation's log: (dR^T R_i^T R_j, r_v,
    r_p), so that a caller can take one batched log of several factors'
    rotations."""
    dt = pre.dt[..., None]
    Rit = R_i.transpose(-1, -2)
    E = pre.dR.transpose(-1, -2) @ Rit @ R_j
    r_v = _matvec(Rit, v_j - v_i - g * dt) - pre.dv
    r_p = _matvec(Rit, t_j - t_i - v_i * dt - 0.5 * g * dt * dt) - pre.dp
    return E, r_v, r_p


def imu_residual(pre: Preintegrated, R_i, t_i, v_i, bg_i, ba_i, R_j, t_j,
                 v_j, g: torch.Tensor) -> torch.Tensor:
    """9-dof residual of the preintegrated IMU factor, batched over any
    leading axes (the biases enter through the re-preintegration, not
    here, as in the JAX package):

      r_R = Log(dR^T R_i^T R_j)
      r_v = R_i^T (v_j - v_i - g dt) - dv
      r_p = R_i^T (t_j - t_i - v_i dt - 0.5 g dt^2) - dp
    """
    E, r_v, r_p = imu_residual_parts(pre, R_i, t_i, v_i, R_j, t_j, v_j, g)
    return torch.cat([lie.so3_log(E), r_v, r_p], dim=-1)


def _matvec(M, x):
    return torch.sum(M * x[..., None, :], dim=-1)
