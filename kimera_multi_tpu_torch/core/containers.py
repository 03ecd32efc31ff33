"""Pose-graph containers and loop-closure status codes.

The JAX package's core/containers.py as plain dataclasses of tensors:
`PoseGraphEdges` (struct-of-arrays measurements, capacity E, padding rows
typed EDGE_INVALID), `GncState` and `LiftedPoseBlocks`, each with a
`.to(device)`; and the verification status of every attempted loop
closure, with the values and names of the reference's
output_lcd_status.csv.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Edge-type codes for PoseGraphEdges.etype (dpgo's measurement routing:
# odometry, private loop closure, shared loop closure).
EDGE_INVALID = 0
EDGE_ODOMETRY = 1
EDGE_PRIVATE_LC = 2
EDGE_SHARED_LC = 3


def _to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)})


@dataclasses.dataclass(eq=False)
class PoseGraphEdges:
    """Struct-of-arrays pose-graph measurements, capacity E. Nodes are
    (robot, local index); `global_ids` flattens them for a given number of
    poses per robot."""

    src_robot: torch.Tensor  # (E,) int32
    src_pose: torch.Tensor  # (E,) int32
    dst_robot: torch.Tensor  # (E,) int32
    dst_pose: torch.Tensor  # (E,) int32
    R: torch.Tensor  # (E, 3, 3) measured relative rotation
    t: torch.Tensor  # (E, 3) measured relative translation
    kappa: torch.Tensor  # (E,) rotation precision
    tau: torch.Tensor  # (E,) translation precision
    etype: torch.Tensor  # (E,) int32 EDGE_* codes; EDGE_INVALID = padding

    @property
    def capacity(self) -> int:
        return self.src_robot.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.etype != EDGE_INVALID

    def global_ids(self, poses_per_robot: int):
        src = self.src_robot.long() * poses_per_robot + self.src_pose.long()
        dst = self.dst_robot.long() * poses_per_robot + self.dst_pose.long()
        return src, dst

    def to(self, device) -> "PoseGraphEdges":
        return _to(self, device)

    @staticmethod
    def empty(capacity: int, dtype=torch.float32,
              device="cpu") -> "PoseGraphEdges":
        zi = torch.zeros((capacity,), dtype=torch.int32, device=device)
        return PoseGraphEdges(
            src_robot=zi, src_pose=zi.clone(), dst_robot=zi.clone(),
            dst_pose=zi.clone(),
            R=torch.eye(3, dtype=dtype, device=device).expand(
                capacity, 3, 3).clone(),
            t=torch.zeros((capacity, 3), dtype=dtype, device=device),
            kappa=torch.zeros((capacity,), dtype=dtype, device=device),
            tau=torch.zeros((capacity,), dtype=dtype, device=device),
            etype=zi.clone())


_EDGE_FIELDS = ("src_robot", "src_pose", "dst_robot", "dst_pose", "R", "t",
                "kappa", "tau", "etype")


def concat_edges(batches, capacity: int | None = None,
                 device=None) -> PoseGraphEdges:
    """Merge edge batches into one capacity-padded graph (host side). Only
    valid rows of each batch are kept, in the order given; padding rows
    carry EDGE_INVALID. The capacity defaults to the next power of two
    (at least 8); more edges than `capacity` raise ValueError."""
    batches = list(batches)
    cols = {f: [] for f in _EDGE_FIELDS}
    for b in batches:
        keep = b.valid.cpu().numpy()
        for f in cols:
            cols[f].append(getattr(b, f).cpu().numpy()[keep])
    E = sum(len(c) for c in cols["etype"])
    cap = capacity or int(2 ** np.ceil(np.log2(max(E, 8))))
    if E > cap:
        raise ValueError(f"{E} edges exceed capacity {cap}")
    if device is None:
        device = batches[0].etype.device if batches else "cpu"
    out = PoseGraphEdges.empty(cap, device=device)
    for f in _EDGE_FIELDS:
        if E:
            v = torch.from_numpy(np.concatenate(cols[f]))
            getattr(out, f)[:E] = v.to(device, getattr(out, f).dtype)
    return out


@dataclasses.dataclass(eq=False)
class GncState:
    """Graduated non-convexity (TLS) outer-loop state."""

    mu: torch.Tensor  # () convexity parameter
    weights: torch.Tensor  # (E,) in [0, 1]
    barc2: torch.Tensor  # () squared inlier threshold
    outer_iter: torch.Tensor  # () int32

    def to(self, device) -> "GncState":
        return _to(self, device)


@dataclasses.dataclass(eq=False)
class LiftedPoseBlocks:
    """Rank-lifted pose variables, robot-blocked: Y (R, N, r, d+1).
    `active` masks robots that are out, `num_poses` is the logical length
    of each robot's chain."""

    Y: torch.Tensor  # (R, N, r, d+1)
    active: torch.Tensor  # (R,) bool
    num_poses: torch.Tensor  # (R,) int32

    @property
    def n_robots(self) -> int:
        return self.Y.shape[0]

    @property
    def pose_capacity(self) -> int:
        return self.Y.shape[1]

    @property
    def rank(self) -> int:
        return self.Y.shape[2]

    @property
    def d(self) -> int:
        return self.Y.shape[3] - 1

    @property
    def pose_valid(self) -> torch.Tensor:
        idx = torch.arange(self.pose_capacity, device=self.Y.device)[None, :]
        return (idx < self.num_poses[:, None]) & self.active[:, None]

    def to(self, device) -> "LiftedPoseBlocks":
        return _to(self, device)


LCD_LOOP_DETECTED = 0
LCD_FAILED_TEMPORAL_CONSTRAINT = 1
LCD_FAILED_GEOM_VERIFICATION = 2
LCD_FAILED_POSE_RECOVERY = 3
LCD_NO_MATCHES = 4
LCD_STATUS_NAMES = {
    LCD_LOOP_DETECTED: "LOOP_DETECTED",
    LCD_FAILED_TEMPORAL_CONSTRAINT: "FAILED_TEMPORAL_CONSTRAINT",
    LCD_FAILED_GEOM_VERIFICATION: "FAILED_GEOM_VERIFICATION",
    LCD_FAILED_POSE_RECOVERY: "FAILED_POSE_RECOVERY",
    LCD_NO_MATCHES: "NO_MATCHES",
}
