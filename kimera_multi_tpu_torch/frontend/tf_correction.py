"""World-frame correction: odometry frame -> optimized frame (the JAX
package's frontend/tf_correction.py).

Each robot keeps the transform that carries its live odometry estimate
into the globally optimized frame (the reference's tfTimerCallback
family), so downstream consumers (mesh deformation, navigation) can
correct poses between back-end rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie


class WorldCorrection(NamedTuple):
    R: torch.Tensor  # (3, 3) T_world_odom rotation
    t: torch.Tensor  # (3,)


def world_to_odom_correction(R_odom_kf: torch.Tensor, t_odom_kf: torch.Tensor,
                             R_world_kf: torch.Tensor,
                             t_world_kf: torch.Tensor) -> WorldCorrection:
    """T_world_odom = T_world_kf * T_odom_kf^-1, from the latest keyframe's
    pose in the odometry frame and in the optimized world frame."""
    Ri, ti = lie.se3_inverse(R_odom_kf, t_odom_kf)
    R, t = lie.se3_compose(R_world_kf, t_world_kf, Ri, ti)
    return WorldCorrection(R=R, t=t)


def apply_correction(corr: WorldCorrection, R_odom: torch.Tensor,
                     t_odom: torch.Tensor):
    """Carry odometry-frame poses (..., 3, 3) / (..., 3) into the world."""
    n = tuple(R_odom.shape[:-2])
    return lie.se3_compose(corr.R.expand(*n, 3, 3), corr.t.expand(*n, 3),
                           R_odom, t_odom)
