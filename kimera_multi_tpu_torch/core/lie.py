"""Batched SO(3) / SE(3) Lie-group operations (the JAX package's
core/lie.py).

Rotations are (..., 3, 3), translations (..., 3), quaternions (..., 4) in
(qx, qy, qz, qw) order. Every function broadcasts over leading batch axes
and is branchless: the small-angle and near-pi branches are chosen per
element with `torch.where`, with the JAX package's epsilons, so no value
is read back to the host.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _check_last(x: torch.Tensor, dims: tuple, name: str) -> None:
    if tuple(x.shape[-len(dims):]) != dims:
        raise ValueError(
            f"{name}: expected trailing shape {dims}, got {tuple(x.shape)}")


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric."""
    _check_last(w, (3,), "hat")
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    _check_last(w, (3,), "so3_exp")
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta2s = torch.clamp(theta2, min=_EPS)
    theta = torch.sqrt(theta2s)
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2s)
    W = hat(w)
    return _eye_like(W) + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map: (..., 3, 3) rotation -> (..., 3) axis-angle, with the
    JAX package's atan2 angle, its Taylor branch below 1e-4 and its
    symmetric-part branch within 1e-3 of pi, chosen per element."""
    _check_last(R, (3, 3), "so3_log")
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_t = torch.sqrt(torch.sum(w_skew * w_skew, dim=-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3

    scale = torch.where(
        small, 1.0 + theta * theta / 6.0,
        theta / torch.where(torch.abs(sin_t) < _EPS,
                            torch.full_like(sin_t, _EPS), sin_t))
    w_generic = w_skew * scale[..., None]

    # near pi: a a^T from the symmetric part of R,
    # (R + R^T)/2 = cos I + (1 - cos) a a^T
    one_minus_c = torch.clamp(1.0 - cos_t, min=_EPS)[..., None, None]
    aaT = ((R + R.transpose(-1, -2)) * 0.5
           - cos_t[..., None, None] * _eye_like(R)) / one_minus_c
    diag = torch.stack([aaT[..., 0, 0], aaT[..., 1, 1], aaT[..., 2, 2]],
                       dim=-1)
    axis_abs = torch.sqrt(torch.clamp(diag, min=1e-12))
    # column k of a a^T is a * a_k: take the largest |a_k| (first on ties)
    k = torch.argmax(axis_abs, dim=-1, keepdim=True)  # (..., 1)
    Bk = torch.take_along_dim(
        aaT, k[..., None].expand(*k.shape[:-1], 3, 1), dim=-1)[..., 0]
    denom = torch.take_along_dim(axis_abs, k, dim=-1)
    axis = Bk / torch.clamp(denom, min=_EPS)
    norm = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True) + 1e-24)
    axis = axis / torch.clamp(norm, min=_EPS)
    sign = torch.where(torch.sum(axis * w_skew, dim=-1, keepdim=True) < 0.0,
                       -1.0, 1.0)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(qx, qy, qz, qw) -> (..., 3, 3). Normalizes the quaternion first."""
    _check_last(q, (4,), "quat_to_rot")
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=_EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (qx, qy, qz, qw) with qw >= 0: Shepperd's method,
    all four candidates computed and the largest denominator taken."""
    _check_last(R, (3, 3), "rot_to_quat")
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(t, a, b, c, d):
        s = torch.sqrt(torch.clamp(t, min=_EPS)) * 2.0  # 4 |q_k|
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1)

    qw_c = cand(1.0 + tr, m21 - m12, m02 - m20, m10 - m01, 1.0 + tr)
    qx_c = cand(1.0 + m00 - m11 - m22, 1.0 + m00 - m11 - m22, m01 + m10,
                m02 + m20, m21 - m12)
    qy_c = cand(1.0 - m00 + m11 - m22, m01 + m10, 1.0 - m00 + m11 - m22,
                m12 + m21, m02 - m20)
    qz_c = cand(1.0 - m00 - m11 + m22, m02 + m20, m12 + m21,
                1.0 - m00 - m11 + m22, m10 - m01)
    scores = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    k = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw_c, qx_c, qy_c, qz_c], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(
        cands, k[..., None, None].expand(*k.shape, 1, 4), dim=-2)[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=_EPS)
    return torch.where(q[..., 3:4] < 0.0, -q, q)


def mat3_mul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) blocks as separate products and sums in a
    fixed order, ((a0 b0 + a1 b1) + a2 b2): the same bits on the card and
    on the CPU (a batched matmul on the card contracts into fused
    multiply-adds; torch's CPU matmul of 3 x 3 blocks rounds as this
    does). For values that decide something on both devices."""
    return ((A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :])
            + A[..., :, 2:3] * B[..., 2:3, :])


def mat3_vec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v for (..., 3, 3) and (..., 3), in `mat3_mul`'s fixed order."""
    return ((A[..., :, 0] * v[..., 0:1] + A[..., :, 1] * v[..., 1:2])
            + A[..., :, 2] * v[..., 2:3])


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) * (R2, t2) = (R1 R2, R1 t2 + t1), in `mat3_mul`'s fixed
    order (same bits on every device)."""
    return mat3_mul(R1, R2), mat3_vec(R1, t2) + t1


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    """Inverse of the rigid transform x -> R x + t, in `mat3_mul`'s fixed
    order. R (..., 3, 3), t (..., 3)."""
    Rt = R.transpose(-1, -2)
    return Rt, -mat3_vec(Rt, t)


def se3_between(Ra, ta, Rb, tb):
    """Relative transform a^-1 * b (GTSAM's BetweenFactor)."""
    Ri, ti = se3_inverse(Ra, ta)
    return se3_compose(Ri, ti, Rb, tb)


def se3_apply(R, t, p):
    """Apply the transform to points p (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def so3_project(M: torch.Tensor) -> torch.Tensor:
    """Closest rotation to (..., 3, 3) M: SVD with the determinant
    correction (the rounding step of chordal initialization)."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def se3_exp(xi: torch.Tensor):
    """se(3) exp of xi (..., 6) = (w, v), rotation first (GTSAM's
    Pose3::Expmap order). Returns (R, t)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta2s = torch.clamp(theta2, min=_EPS)
    theta = torch.sqrt(theta2s)
    small = theta2 < _EPS
    W = hat(w)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2s * theta))
    V = _eye_like(R) + b * W + c * (W @ W)
    return R, torch.einsum("...ij,...j->...i", V, v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp: (..., 6) = (w, v)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta2s = torch.clamp(theta2, min=_EPS)
    theta = torch.sqrt(theta2s)
    small = theta2 < _EPS
    W = hat(w)
    # V^-1 = I - W/2 + (1/theta^2)(1 - theta sin / (2 (1 - cos))) W^2
    half_t = theta * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t)
         / torch.clamp(torch.sin(half_t), min=_EPS)) / theta2s)
    Vinv = _eye_like(R) - 0.5 * W + cot_term * (W @ W)
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def rotation_geodesic_distance(Ra: torch.Tensor,
                               Rb: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations."""
    Rrel = Ra.transpose(-1, -2) @ Rb
    trace = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    return torch.acos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
