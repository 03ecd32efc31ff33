"""State carried across from the JAX package.

The JAX package hands its state over as numpy arrays and plain values
(this module imports neither jax nor that package): the keyframe stores,
the raw words of a threefry key (`jax.random.key_data(key)`), its
`FrontendConfig`, its BoW `Vocabulary`, the back-end's pose graph,
SE(3) parameters, lifted blocks and GNC state, loop-closure records and
submap assignments. What comes out computes the same thing in the port;
loop-closure records also go the other way, as numpy rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.containers import GncState, LiftedPoseBlocks, PoseGraphEdges
from .frontend.dlc import FrontendConfig
from .frontend.lcd import LcdParams
from .frontend.vocab import Vocabulary, _from_numpy


def stores_from_numpy(desc, obs_valid, bearings, landmarks, device="cuda"):
    """Keyframe stores as contiguous tensors on `device`:
    desc (R, T, K, 32) uint8, obs_valid (R, T, K) bool, bearings /
    landmarks (R, T, 3, K) f32 coordinate-major."""
    desc = np.ascontiguousarray(desc, np.uint8)
    obs_valid = np.ascontiguousarray(obs_valid, bool)
    bearings = np.ascontiguousarray(bearings, np.float32)
    landmarks = np.ascontiguousarray(landmarks, np.float32)
    R, T, K, nb = desc.shape
    if nb != 32 or obs_valid.shape != (R, T, K) \
            or bearings.shape != (R, T, 3, K) \
            or landmarks.shape != (R, T, 3, K):
        raise ValueError("stores do not have the (R, T, K, 32) / (R, T, K) "
                         "/ (R, T, 3, K) layout")
    return tuple(torch.from_numpy(a).to(device)
                 for a in (desc, obs_valid, bearings, landmarks))


def key_from_jax_key_data(key_data, device="cpu") -> torch.Tensor:
    """The two uint32 words of a threefry2x32 key -> the port's key."""
    words = np.asarray(key_data)
    if words.shape[-1] != 2:
        raise ValueError("expected the (..., 2) uint32 words of a "
                         "threefry2x32 key")
    return torch.from_numpy(words.astype(np.int64)).to(device)


def config_from_jax(cfg) -> FrontendConfig:
    """The JAX package's FrontendConfig (any object with the same field
    names, its `lcd` parameters included) -> the port's."""
    fields = {f: getattr(cfg, f) for f in FrontendConfig._fields}
    fields["lcd"] = LcdParams(**{f: getattr(cfg.lcd, f)
                                 for f in LcdParams._fields})
    return FrontendConfig(**fields)


def vocabulary_from_numpy(k, depth, centroids, word_weights, node_valid,
                          device="cuda") -> Vocabulary:
    """The fields of the JAX package's `Vocabulary` as numpy arrays (per
    level (k^(l+1), 32) uint8 centroids and (k^(l+1),) bool validity,
    (k^depth,) float32 idf weights) -> the port's, on `device`."""
    if len(centroids) != depth or len(node_valid) != depth:
        raise ValueError("expected one centroid and one validity array "
                         "per level")
    for lvl, (c, v) in enumerate(zip(centroids, node_valid)):
        n = k ** (lvl + 1)
        if np.shape(c) != (n, 32) or np.shape(v) != (n,):
            raise ValueError(f"level {lvl}: expected ({n}, 32) centroids "
                             f"and ({n},) validity")
    if np.shape(word_weights) != (k ** depth,):
        raise ValueError(f"expected ({k ** depth},) word weights")
    return _from_numpy(k, depth, [np.asarray(c) for c in centroids],
                       np.asarray(word_weights),
                       [np.asarray(v) for v in node_valid], device)


def edges_from_numpy(src_robot, src_pose, dst_robot, dst_pose, R, t, kappa,
                     tau, etype, device="cuda") -> PoseGraphEdges:
    """The fields of the JAX package's `PoseGraphEdges` as numpy arrays ->
    the port's, on `device` (int32 indices and codes, float32 values)."""
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    E = np.shape(etype)[0]
    if np.shape(R) != (E, 3, 3) or np.shape(t) != (E, 3):
        raise ValueError("expected (E, 3, 3) rotations and (E, 3) "
                         "translations")
    return PoseGraphEdges(
        src_robot=i32(src_robot), src_pose=i32(src_pose),
        dst_robot=i32(dst_robot), dst_pose=i32(dst_pose), R=f32(R), t=f32(t),
        kappa=f32(kappa), tau=f32(tau), etype=i32(etype)).to(device)


def pgo_params_from_numpy(R, t, device="cuda"):
    """The JAX package's `PgoParams` (R (N, 3, 3), t (N, 3)) -> the
    port's."""
    from .solve.pgo import PgoParams

    return PgoParams(R=torch.tensor(np.asarray(R, np.float32), device=device),
                     t=torch.tensor(np.asarray(t, np.float32), device=device))


def lifted_from_numpy(Y, active=None, num_poses=None,
                      device="cuda") -> LiftedPoseBlocks:
    """Lifted blocks Y (R, N, r, d+1) -> `LiftedPoseBlocks`; every robot
    active and every pose in use unless told otherwise."""
    Y = torch.tensor(np.asarray(Y, np.float32))
    n_robots, n_poses = Y.shape[:2]
    active = (np.ones(n_robots, bool) if active is None
              else np.asarray(active, bool))
    num_poses = (np.full(n_robots, n_poses, np.int32) if num_poses is None
                 else np.asarray(num_poses, np.int32))
    return LiftedPoseBlocks(Y=Y, active=torch.from_numpy(active),
                            num_poses=torch.from_numpy(num_poses)).to(device)


def gnc_state_from_numpy(mu, weights, barc2, outer_iter,
                         device="cuda") -> GncState:
    """The fields of the JAX package's `GncState` -> the port's."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    return GncState(mu=f32(mu), weights=f32(weights), barc2=f32(barc2),
                    outer_iter=torch.tensor(
                        np.asarray(outer_iter, np.int32))).to(device)



def round_state_from_numpy(Y, active, mu, weights, barc2, outer_iter,
                           round_idx, device="cuda"):
    """The fields of the JAX package's `dist.rounds.RoundState` (its
    GncState's fields flattened, as its checkpoints hold them) -> the
    port's `RoundState`, whose round index is a Python int."""
    from .dist.rounds import RoundState

    return RoundState(
        Y=torch.tensor(np.asarray(Y, np.float32), device=device),
        active=torch.tensor(np.asarray(active, bool), device=device),
        gnc_state=gnc_state_from_numpy(mu, weights, barc2, outer_iter,
                                       device=device),
        round_idx=int(np.asarray(round_idx)))

_LOOP_INT_FIELDS = ("robot_a", "frame_a", "robot_b", "frame_b",
                    "mono_inliers", "stereo_inliers", "status")


def loops_to_numpy(loops) -> dict:
    """Loop-closure records (`VerifiedLC`, the port's or the JAX
    package's: the same fields) -> one numpy array per field: int32
    indices, counts and status, (n, 3, 3) / (n, 3) float32 poses,
    float64 BoW scores, bool acceptance."""
    loops = list(loops)
    out = {f: np.asarray([getattr(lc, f) for lc in loops], np.int32)
           for f in _LOOP_INT_FIELDS}
    out["R"] = np.asarray([np.asarray(lc.R, np.float32) for lc in loops],
                          np.float32).reshape(-1, 3, 3)
    out["t"] = np.asarray([np.asarray(lc.t, np.float32) for lc in loops],
                          np.float32).reshape(-1, 3)
    out["bow_score"] = np.asarray([lc.bow_score for lc in loops],
                                  np.float64)
    out["accepted"] = np.asarray([lc.accepted for lc in loops], bool)
    return out


def loops_from_numpy(rows: dict, record=None) -> list:
    """The arrays of `loops_to_numpy` -> a list of records, each built as
    `record(**fields)` with plain ints, floats and bools (the port's
    `VerifiedLC` unless another record type with the same fields is
    given)."""
    from .frontend.dlc import VerifiedLC

    record = record or VerifiedLC
    return [record(**{f: int(rows[f][i]) for f in _LOOP_INT_FIELDS},
                   R=rows["R"][i], t=rows["t"][i],
                   bow_score=float(rows["bow_score"][i]),
                   accepted=bool(rows["accepted"][i]))
            for i in range(len(rows["status"]))]


def submap_assignment_from_numpy(submap_of_kf, anchor_kf, n_submaps,
                                 R_in_submap, t_in_submap, device="cuda"):
    """The fields of the JAX package's `SubmapAssignment` -> the port's,
    on `device`."""
    from .frontend.submap import SubmapAssignment

    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return SubmapAssignment(
        submap_of_kf=i32(submap_of_kf), anchor_kf=i32(anchor_kf),
        n_submaps=int(n_submaps), R_in_submap=f32(R_in_submap),
        t_in_submap=f32(t_in_submap))


def vio_config_from_jax(cfg):
    """The JAX package's VIO `PipelineConfig` (any object with the same
    field names, its nested `GfttParams`, `KltParams`, `VioConfig`,
    `ImuParams` and `CameraModel` included) -> the port's."""
    from .vio import imu, pipeline, smoother, tracking, undistort

    nested = {"gftt": tracking.GfttParams, "klt": tracking.KltParams,
              "vio": smoother.VioConfig, "imu": imu.ImuParams,
              "cam": undistort.CameraModel}
    fields = {}
    for f in pipeline.PipelineConfig._fields:
        v = getattr(cfg, f)
        if f in nested:
            v = nested[f](**{g: getattr(v, g) for g in nested[f]._fields})
        fields[f] = v
    return pipeline.PipelineConfig(**fields)


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def vio_state_from_numpy(R, t, v, bg, ba, device="cuda"):
    """The fields of the JAX package's `VioState` ((W, 3, 3) and (W, 3)
    arrays) -> the port's, float32 on `device`."""
    from .vio.smoother import VioState

    return VioState(*(_f32(a, device) for a in (R, t, v, bg, ba)))


def preintegrated_from_numpy(device="cuda", **fields):
    """The fields of the JAX package's `Preintegrated` as numpy arrays
    (by name) -> the port's, float32 on `device`."""
    from .vio.imu import Preintegrated

    return Preintegrated(**{f: _f32(fields[f], device)
                            for f in Preintegrated._fields})


def vio_window_from_numpy(pre: dict, anchor: dict, device="cuda", **fields):
    """The JAX package's `VioWindow` as numpy: `pre` and `anchor` the
    fields of its `Preintegrated` and anchor `VioState` by name, the other
    fields by name (bool masks stay bool; absent optional fields None) ->
    the port's on `device`."""
    from .vio.smoother import VioWindow

    out = {}
    for f in VioWindow._fields:
        if f in ("pre", "anchor") or fields.get(f) is None:
            continue
        a = np.asarray(fields[f])
        out[f] = (torch.tensor(a, device=device) if a.dtype == bool
                  else _f32(a, device))
    return VioWindow(pre=preintegrated_from_numpy(device, **pre),
                     anchor=vio_state_from_numpy(**anchor, device=device),
                     **out)


_KF_FIELDS = ("timestamp", "R", "t", "v", "track_ids", "pts", "bearings",
              "landmarks", "lm_valid", "descriptors", "valid",
              "mono_inliers", "stereo_inliers", "n_rejected")


def keyframes_to_numpy(keyframes) -> dict:
    """VIO `KeyframeOutput` records (the port's or the JAX package's: the
    same fields) -> one numpy array per field, stacked over keyframes."""
    return {f: np.stack([np.asarray(getattr(k, f)) for k in keyframes])
            for f in _KF_FIELDS}


def tsdf_grid_from_numpy(tsdf, weight, sem_hist, origin, voxel_size, trunc,
                         device="cuda"):
    """A TSDF grid (the JAX package's TsdfGrid fields as numpy arrays and
    floats) -> the port's `semantics.tsdf.TsdfGrid` on `device`."""
    from .semantics.tsdf import TsdfGrid

    return TsdfGrid(tsdf=_f32(tsdf, device), weight=_f32(weight, device),
                    sem_hist=_f32(sem_hist, device),
                    origin=_f32(origin, device),
                    voxel_size=float(voxel_size), trunc=float(trunc))


def deformation_state_from_numpy(R, t, device="cuda"):
    """Deformation-graph node transforms R (G, 3, 3), t (G, 3) -> the
    port's `solve.deformation.DeformationState` on `device`."""
    from .solve.deformation import DeformationState

    return DeformationState(R=_f32(R, device), t=_f32(t, device))
