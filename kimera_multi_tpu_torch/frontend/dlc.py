"""The sequential distributed loop-closure front-end, its configuration,
loop-closure records and the pose-graph assembly (the JAX package's
frontend/dlc.py: `FrontendConfig`, `VerifiedLC`, `DistributedFrontend`,
`build_pose_graph_from_loops`).

`DistributedFrontend` is the reference's per-keyframe round (its
runDetection / runVerification threads on one host): each keyframe's BoW
vector is scored against every robot's database, the temporal gate
decides, and each gated pair is verified alone, through the same kernels
as the batched front-end with a candidate axis of 1. It makes the same
detections, keys and verification decisions as `batched.BatchedFrontend`
and fills `loops` and `lcd_attempts` in the same order, equal bit for
bit on either device: the verifier sums in an order that does not depend
on the batch size (kernels/minimal.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import backend, rng as rngmod
from ..core.containers import (
    EDGE_ODOMETRY,
    EDGE_PRIVATE_LC,
    EDGE_SHARED_LC,
    LCD_FAILED_GEOM_VERIFICATION,
    LCD_FAILED_POSE_RECOVERY,
    LCD_LOOP_DETECTED,
    PoseGraphEdges,
)
from ..kernels import bow as bow_kernel
from . import bow_db, lcd as lcd_mod, vocab as vocab_mod
from .lcd import LcdParams


class FrontendConfig(NamedTuple):
    lcd: LcdParams = LcdParams()
    bow_capacity: int = 128  # words per BoW vector
    lowe_ratio: float = 0.7
    ransac_hyp: int = 500
    mono_threshold: float = 1e-6
    stereo_threshold: float = 0.3
    min_mono_inliers: int = 10
    min_stereo_inliers: int = 5
    kappa_lc: float = 1e4
    tau_lc: float = 1e2
    kappa_odo: float = 1e4
    tau_odo: float = 1e2
    min_intra_separation: int = 10  # skip near-diagonal self matches
    # 5-pt minimal mono gate by default (ransac_essential_5pt), as in the
    # JAX package; use_5pt=False takes the 8-point gate
    use_5pt: bool = True
    base_seed: int = 0


class VerifiedLC(NamedTuple):
    robot_a: int
    frame_a: int
    robot_b: int
    frame_b: int
    R: np.ndarray  # T^a_b (pose of b's frame expressed in a)
    t: np.ndarray
    mono_inliers: int
    stereo_inliers: int
    bow_score: float
    status: int
    accepted: bool


def lcd_status(mono_ok: bool, stereo_ok: bool) -> int:
    """The LCD status of a verified candidate."""
    if not mono_ok:
        return LCD_FAILED_GEOM_VERIFICATION
    if not stereo_ok:
        return LCD_FAILED_POSE_RECOVERY
    return LCD_LOOP_DETECTED


class DistributedFrontend:
    """The host-driven per-keyframe front-end of one run (all robots).
    Runs on the card unless the caller passes device="cpu"."""

    def __init__(self, n_robots: int, n_steps: int, vocab,
                 cfg: FrontendConfig, device="cuda"):
        from .batched import make_verifier

        self.cfg = cfg
        self.n_robots = n_robots
        self.n_steps = n_steps
        self.device = backend.resolve_device(device)
        self.vocab = vocab.to(self.device)
        self.dbs = [bow_db.empty(n_steps, cfg.bow_capacity,
                                 device=self.device)
                    for _ in range(n_robots)]
        self.prev_bow = [None] * n_robots  # for the nss factor
        self.loops: list[VerifiedLC] = []
        self.lcd_attempts: list[VerifiedLC] = []
        self.bow_overflow = 0
        # temporal-constraint state per (query robot, target robot): the
        # previous best island's representative and the count of
        # consecutive consistent detections (checkTemporalConstraint)
        self.prev_island = torch.full((n_robots, n_robots), -1,
                                      dtype=torch.int64)
        self.consec = torch.zeros((n_robots, n_robots), dtype=torch.int64)
        self._verify = make_verifier(cfg, device=self.device)
        self._key = rngmod.base_key(cfg.base_seed, device=self.device)
        self.stores = None  # (desc, obs, bear, lm) once K is known

    def _store_obs(self, robot, frame, desc, valid, bearings, landmarks):
        """The VLC-frame store: every keyframe's observations, in the
        verifier's layout (descriptors (R, T, K, 32), validity (R, T, K),
        bearings / landmarks (R, T, 3, K) coordinate-major)."""
        if self.stores is None:
            R, T, K = self.n_robots, self.n_steps, desc.shape[0]
            dev = self.device
            self.stores = (
                torch.zeros((R, T, K, 32), dtype=torch.uint8, device=dev),
                torch.zeros((R, T, K), dtype=torch.bool, device=dev),
                torch.zeros((R, T, 3, K), device=dev),
                torch.zeros((R, T, 3, K), device=dev))
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32)).to(self.device).T
        for store, x in zip(self.stores, (desc, valid, f32(bearings),
                                          f32(landmarks))):
            store[robot, frame] = x

    @torch.no_grad()
    def process_keyframe(self, robot: int, frame: int, descriptors,
                         bearings, landmarks, obs_valid) -> list:
        """One robot's keyframe round: BoW, detection against every
        robot's database, the temporal gate, verification of each gated
        pair, then insertion into the robot's own database. Returns the
        newly accepted loop closures (also appended to `loops`)."""
        cfg = self.cfg
        dev = self.device
        desc = torch.as_tensor(np.asarray(descriptors, np.uint8)).to(dev)
        v = torch.as_tensor(np.asarray(obs_valid, bool)).to(dev)
        # the verifier reads the query's row from the stores
        self._store_obs(robot, frame, desc, v, bearings, landmarks)
        words = vocab_mod.transform(self.vocab, desc[None], v[None])
        ids, weights, ovf = vocab_mod.bow_from_words(
            words, self.vocab.word_weights, cfg.bow_capacity)
        ids, weights = ids[0], weights[0]
        self.bow_overflow += int(ovf[0])
        qs_ids, qs_w = bow_kernel.sort_bow(ids, weights)

        # nss factor: similarity to this robot's previous keyframe BoW
        if self.prev_bow[robot] is not None:
            p_ids, p_w = self.prev_bow[robot]
            nss = bow_kernel.l1_scores(
                qs_ids, qs_w, p_ids[None], p_w[None],
                torch.ones(1, dtype=torch.bool, device=dev))[0]
        else:
            nss = torch.ones((), device=dev)
        self.prev_bow[robot] = (ids, weights)

        # every target's detection, then one read of the results
        res = [lcd_mod.detect(self.dbs[target], qs_ids, qs_w, nss, cfg.lcd,
                              self_query_frame=(frame if target == robot
                                                else None))
               for target in range(self.n_robots)]
        match = torch.stack([x.match_id for x in res]).cpu().numpy()
        score = torch.stack([x.island_score for x in res]).cpu().numpy()

        # the temporal constraint, as the batched detection loop
        m0 = torch.from_numpy(match.astype(np.int64))
        gate, self.prev_island[robot], self.consec[robot] = \
            lcd_mod.temporal_gate(m0, m0 >= 0, self.prev_island[robot],
                                  self.consec[robot], cfg.lcd)
        new_loops = []
        for target in np.flatnonzero(gate.numpy()).tolist():
            lc = self._verify_pair(robot, frame, target, int(match[target]),
                                   float(score[target]))
            self.lcd_attempts.append(lc)
            if lc.accepted:
                self.loops.append(lc)
                new_loops.append(lc)

        # insert into the robot's own database after detection (a frame
        # is never matched against itself)
        self.dbs[robot] = bow_db.add(self.dbs[robot], frame, ids, weights)
        return new_loops

    def _verify_pair(self, robot, frame, target, match,
                     score) -> VerifiedLC:
        """One candidate through the batched front-end's verifier (C = 1:
        Hamming 2-NN + Lowe, targets aligned by match, the mono and stereo
        RANSAC gates) under its key derive(base, robot, frame, target,
        match)."""
        ix = lambda x: torch.tensor([x], device=self.device)  # noqa: E731
        out = self._verify(self._key, *self.stores, ix(robot), ix(frame),
                           ix(target), ix(match))
        out = {k: v[0].cpu().numpy() for k, v in out.items()}
        mono_ok, stereo_ok = bool(out["mono_ok"]), bool(out["stereo_ok"])
        return VerifiedLC(
            robot_a=robot, frame_a=frame, robot_b=target, frame_b=match,
            R=out["R"], t=out["t"], mono_inliers=int(out["mono_inliers"]),
            stereo_inliers=int(out["stereo_inliers"]), bow_score=score,
            status=lcd_status(mono_ok, stereo_ok),
            accepted=mono_ok and stereo_ok)

    def process_all(self, descriptors, bearings, landmarks, obs_valid):
        """Every keyframe of a run in the reference's order (step by step,
        robot by robot; a robot without observations at a step skips it):
        descriptors (R, T, K, 32), bearings / landmarks (R, T, K, 3),
        obs_valid (R, T, K). Returns stats (n_keyframes, n_candidates,
        t_frontend seconds on a synchronised clock)."""
        t0 = backend.synced_clock(self.device)
        n_kf = 0
        for k in range(self.n_steps):
            for r in range(self.n_robots):
                if not obs_valid[r, k].any():
                    continue
                n_kf += 1
                self.process_keyframe(r, k, descriptors[r, k],
                                      bearings[r, k], landmarks[r, k],
                                      obs_valid[r, k])
        return dict(n_keyframes=n_kf, n_candidates=len(self.lcd_attempts),
                    t_frontend=backend.synced_clock(self.device) - t0)

    def build_pose_graph(self, R_odo, t_odo, edge_capacity=None):
        """Odometry + the accepted loops as one PoseGraphEdges on the
        front-end's device."""
        return build_pose_graph_from_loops(
            self.loops, R_odo, t_odo, self.cfg, edge_capacity,
            device=self.device)


def build_pose_graph_from_loops(loops, R_odo: np.ndarray, t_odo: np.ndarray,
                                cfg: FrontendConfig,
                                edge_capacity: int | None = None,
                                device="cuda") -> PoseGraphEdges:
    """Odometry + committed loop-closure edges as the back-end's
    PoseGraphEdges (the request_pose_graph service): every robot's
    odometry steps (r, k) -> (r, k + 1) in order, then the loops in
    order, typed private (same robot) or shared; capacity the next power
    of two of the count (at least 8) unless given. Assembled on the host,
    then one copy to `device` (the card unless told otherwise)."""
    dev = backend.resolve_device(device)
    R_odo = np.asarray(R_odo, np.float32)
    t_odo = np.asarray(t_odo, np.float32)
    n_r, n_s = R_odo.shape[0], R_odo.shape[1]
    rr, kk = np.meshgrid(np.arange(n_r), np.arange(n_s), indexing="ij")
    n_odo, n_lc = n_r * n_s, len(loops)
    E = n_odo + n_lc
    cap = edge_capacity or int(2 ** np.ceil(np.log2(max(E, 8))))
    cols = np.zeros((cap, 4), np.int32)
    Rm = np.broadcast_to(np.eye(3, dtype=np.float32), (cap, 3, 3)).copy()
    tm = np.zeros((cap, 3), np.float32)
    et = np.zeros(cap, np.int32)
    cols[:n_odo] = np.stack([rr.ravel(), kk.ravel(), rr.ravel(),
                             kk.ravel() + 1], axis=1)
    Rm[:n_odo] = R_odo.reshape(-1, 3, 3)
    tm[:n_odo] = t_odo.reshape(-1, 3)
    et[:n_odo] = EDGE_ODOMETRY
    if n_lc:
        cols[n_odo:E] = [(lc.robot_a, lc.frame_a, lc.robot_b, lc.frame_b)
                         for lc in loops]
        Rm[n_odo:E] = np.stack([np.asarray(lc.R, np.float32)
                                for lc in loops])
        tm[n_odo:E] = np.stack([np.asarray(lc.t, np.float32)
                                for lc in loops])
        et[n_odo:E] = np.where(cols[n_odo:E, 0] == cols[n_odo:E, 2],
                               EDGE_PRIVATE_LC, EDGE_SHARED_LC)
    kap = np.zeros(cap, np.float32)
    tau = np.zeros(cap, np.float32)
    kap[:n_odo], tau[:n_odo] = cfg.kappa_odo, cfg.tau_odo
    kap[n_odo:E], tau[n_odo:E] = cfg.kappa_lc, cfg.tau_lc
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return PoseGraphEdges(
        src_robot=f(cols[:, 0]), src_pose=f(cols[:, 1]),
        dst_robot=f(cols[:, 2]), dst_pose=f(cols[:, 3]), R=f(Rm), t=f(tm),
        kappa=f(kap), tau=f(tau), etype=f(et))
