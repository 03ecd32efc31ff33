"""Submap coarsening: keyframes -> submaps -> a sparse pose graph (the JAX
package's frontend/submap.py).

The back-end optimizes submap anchor poses only; member keyframes ride
along rigidly (the reference's submap atlas: getSubmapPoseGraph).

`assign_submaps` is a sequential greedy gate. The JAX package runs it as
a `lax.scan`; on the card a step per keyframe would cost about a thousand
tiny launches a robot, and its inputs come from the host's odometry
composition anyway, so the gate runs in numpy float32 (distance as
sqrt((dx^2 + dy^2) + dz^2)) and what it decides goes to the device as
tensors. The relative poses, the edge relabelling and the expansion are
gathers and Lie operations on the device, composed in
`lie.se3_compose`'s order (same bits on the card and the CPU, so
PCM decides the same on the coarse graph).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..core.containers import PoseGraphEdges


class SubmapAssignment(NamedTuple):
    submap_of_kf: torch.Tensor  # (N,) int32 submap index per keyframe
    anchor_kf: torch.Tensor  # (N,) int32 anchor keyframe per submap slot
    n_submaps: int
    # relative pose of each keyframe in its submap's anchor frame
    R_in_submap: torch.Tensor  # (N, 3, 3)
    t_in_submap: torch.Tensor  # (N, 3)



def assign_submaps(R_kf: torch.Tensor, t_kf: torch.Tensor,
                   kf_valid: torch.Tensor, max_submap_size: int = 10,
                   max_submap_distance: float = 5.0) -> SubmapAssignment:
    """Greedy sequential grouping of keyframe poses (odometry frame,
    (N, 3, 3) and (N, 3)): a new submap starts at a valid keyframe when
    the current one holds max_submap_size keyframes or the keyframe is
    more than max_submap_distance from its anchor. Results on R_kf's
    device."""
    N = t_kf.shape[0]
    t = t_kf.detach().cpu().numpy().astype(np.float32)
    valid = kf_valid.detach().cpu().numpy().astype(bool)
    sm_of_kf = np.zeros(N, np.int32)
    anchor_of_kf = np.zeros(N, np.int32)
    sm, anchor, count, anchor_t = 0, 0, 0, t[0]
    for i in range(N):
        d = t[i] - anchor_t
        dist = np.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
        if valid[i] and (count >= max_submap_size
                         or dist > np.float32(max_submap_distance)):
            sm, anchor, anchor_t, count = sm + 1, i, t[i], 1
        else:
            count += int(valid[i])
        sm_of_kf[i], anchor_of_kf[i] = sm, anchor
    anchor_kf = np.zeros(N, np.int32)
    np.maximum.at(anchor_kf, sm_of_kf, anchor_of_kf)
    dev = R_kf.device
    a = torch.from_numpy(anchor_of_kf).to(dev).long()
    # relative pose within the submap: T_anchor^-1 T_kf
    Ri, ti = lie.se3_inverse(R_kf[a], t_kf[a])
    R_rel, t_rel = lie.se3_compose(Ri, ti, R_kf, t_kf)
    return SubmapAssignment(
        submap_of_kf=torch.from_numpy(sm_of_kf).to(dev),
        anchor_kf=torch.from_numpy(anchor_kf).to(dev),
        n_submaps=int(sm_of_kf[-1]) + 1,
        R_in_submap=R_rel, t_in_submap=t_rel)


def coarsen_edges(edges: PoseGraphEdges, assignment_per_robot,
                  poses_per_robot: int) -> PoseGraphEdges:
    """Relabel keyframe-level edges to submap level: an edge
    (a_kf i -> b_kf j) becomes (submap(i) -> submap(j)) with measurement
    T_{anchor_i, i} T_ij T_{anchor_j, j}^-1, an exact relabelling.
    Odometry or loop edges whose two ends fall in one submap of one robot
    become padding (their constraint is inside the rigid submap)."""
    sm = torch.stack([a.submap_of_kf for a in assignment_per_robot])
    Rrel = torch.stack([a.R_in_submap for a in assignment_per_robot])
    trel = torch.stack([a.t_in_submap for a in assignment_per_robot])
    sr, sp = edges.src_robot.long(), edges.src_pose.long()
    dr, dp = edges.dst_robot.long(), edges.dst_pose.long()
    si, sj = sm[sr, sp], sm[dr, dp]
    R1, t1 = lie.se3_compose(Rrel[sr, sp], trel[sr, sp], edges.R, edges.t)
    Rji, tji = lie.se3_inverse(Rrel[dr, dp], trel[dr, dp])
    Rn, tn = lie.se3_compose(R1, t1, Rji, tji)
    same = (edges.src_robot == edges.dst_robot) & (si == sj)
    keep = edges.valid & ~same
    return PoseGraphEdges(
        src_robot=edges.src_robot, src_pose=si, dst_robot=edges.dst_robot,
        dst_pose=sj, R=Rn, t=tn, kappa=edges.kappa, tau=edges.tau,
        etype=torch.where(keep, edges.etype, 0))


def expand_solution(R_sm: torch.Tensor, t_sm: torch.Tensor,
                    assignment: SubmapAssignment,
                    robot_submap_offset: int):
    """Keyframe poses from optimized submap anchors: T_kf = T_submap
    T_{anchor, kf} (R_sm (S_total, 3, 3), t_sm (S_total, 3); the robot's
    submaps start at robot_submap_offset)."""
    idx = robot_submap_offset + assignment.submap_of_kf.long()
    return lie.se3_compose(R_sm[idx], t_sm[idx], assignment.R_in_submap,
                           assignment.t_in_submap)
