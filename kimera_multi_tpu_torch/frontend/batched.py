"""Batched distributed loop-closure front-end.

The batched counterpart of the per-(robot, keyframe, target) host loop of
the system this one is modelled on (its runDetection / runVerification
threads): two device stages with one host round-trip between them.

  stage 1 DETECT  a loop over keyframe steps (`make_detector`). Each step
                  scores every robot's query BoW against EVERY robot's
                  database in one batched L1-scoring call, computes islands
                  and the temporal gate, and emits up to `n_candidates`
                  loop candidates per (query robot, target robot).
  stage 2 VERIFY  one call per fixed-size chunk of the compacted candidate
                  list (`make_verifier`): pair Hamming 2-NN + Lowe, then
                  mono-essential RANSAC (5-point by default, 8-point with
                  `use_5pt=False`) and 3d3d-Arun RANSAC over the chunk.
                  Results for a candidate depend only on its structural
                  address (query robot/frame, target robot/frame) and the
                  base key, never on the chunk it is verified in.

Temporal constraint (checkTemporalConstraint): the loop carries the
previous best-island representative and a consecutive-consistency counter
per (query robot, target database); detections fire only after
`min_temporal_matches` consecutive temporally consistent matches
(pass-through when min_temporal_matches <= 1).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import backend, lie, rng as rngmod
from ..kernels import bow as bow_kernel, gather, hamming, ransac
from . import lcd as lcd_mod, vocab as vocab_mod
from .dlc import (FrontendConfig, VerifiedLC, build_pose_graph_from_loops,
                  lcd_status)


class DetectOutputs(NamedTuple):
    match: torch.Tensor  # (T, R, R, C) int32 match frame, -1 if none
    score: torch.Tensor  # (T, R, R, C) f32 island score
    detected: torch.Tensor  # (T, R, R, C) bool
    nss: torch.Tensor  # (T, R) f32 per-query nss factor


def make_detector(n_robots: int, n_steps: int, cfg: FrontendConfig,
                  n_candidates: int = 1, db_block: int | None = None,
                  device="cuda"):
    """Builds `detect_all(ids, weights, qids, qweights, kf_valid)`: the
    detection loop over all keyframe steps of a run, on the card unless the
    caller passes device="cpu".

    Inputs: per-frame packed BoW vectors for the whole run (ids / weights
    (R, T, W), their sorted query copies from `sort_bow`, kf_valid (R, T)).
    Returns (DetectOutputs, (db_ids, db_weights, db_valid)): the
    detections per step and the final databases.

    Per step every query robot scores every target robot's database:
    O(R^2 T W log W) work per step. `db_block` cuts the target-frame axis
    into blocks of that many frames, so live intermediates are
    O(R^2 db_block W) whatever the run length; the (R, T, W) database is
    the only O(T) residency. Default: one block up to T = 512, blocks of
    512 above. Blocking reorganizes the same arithmetic: the scores are
    identical.
    """
    R, T = n_robots, n_steps
    W = cfg.bow_capacity
    params = cfg.lcd
    C = n_candidates
    window = params.recent_frames_window
    if db_block is None:
        db_block = T if T <= 512 else 512
    dev = backend.resolve_device(device)

    @torch.no_grad()
    def detect_all(ids, weights, qids, qweights, kf_valid):
        ids = torch.as_tensor(ids, device=dev).to(torch.int32)
        weights = torch.as_tensor(weights, device=dev).to(torch.float32)
        qids = torch.as_tensor(qids, device=dev).to(torch.int32)
        qweights = torch.as_tensor(qweights, device=dev).to(torch.float32)
        kf_valid = torch.as_tensor(kf_valid, device=dev).to(torch.bool)

        db_ids = torch.full((R, T, W), -1, dtype=torch.int32, device=dev)
        db_w = torch.zeros((R, T, W), device=dev)
        db_valid = torch.zeros((R, T), dtype=torch.bool, device=dev)
        prev_ids = torch.full((R, W), -1, dtype=torch.int32, device=dev)
        prev_w = torch.zeros((R, W), device=dev)
        prev_ok = torch.zeros((R,), dtype=torch.bool, device=dev)
        prev_island = torch.full((R, R), -1, dtype=torch.int32, device=dev)
        consec = torch.zeros((R, R), dtype=torch.int32, device=dev)
        out_m = torch.full((T, R, R, C), -1, dtype=torch.int32, device=dev)
        out_s = torch.zeros((T, R, R, C), device=dev)
        out_d = torch.zeros((T, R, R, C), dtype=torch.bool, device=dev)
        out_nss = torch.ones((T, R), device=dev)
        rr = torch.arange(R, device=dev)
        frame_idx = torch.arange(T, device=dev)
        one = torch.ones((R, 1), dtype=torch.bool, device=dev)

        for k in range(T):
            ids_k, w_k, kf_ok = ids[:, k], weights[:, k], kf_valid[:, k]
            qids_k, qw_k = qids[:, k], qweights[:, k]
            # nss factor: similarity to this robot's previous keyframe BoW
            s_prev = bow_kernel.l1_scores(qids_k, qw_k, prev_ids[:, None],
                                          prev_w[:, None], one)[:, 0]
            nss = torch.where(prev_ok, s_prev, 1.0)

            # insert step-k BoWs BEFORE querying; the per-pair frame bounds
            # keep the sequential robot order (robot r's query sees robot
            # t < r's frame k, robot t > r's only up to k - 1, its own up
            # to k - window)
            db_ids[:, k] = torch.where(kf_ok[:, None], ids_k, -1)
            db_w[:, k] = torch.where(kf_ok[:, None], w_k, 0.0)
            db_valid[:, k] = kf_ok
            bound = torch.where(
                rr[:, None] > rr[None, :], k + 1,
                torch.where(rr[:, None] < rr[None, :], k, k - window + 1))
            mask = db_valid[None] & (frame_idx < bound[..., None])

            # (R query, R target, T) raw L1 scores, block by block
            scores = torch.cat([
                bow_kernel.l1_scores(
                    qids_k[:, None], qw_k[:, None],
                    db_ids[None, :, lo:lo + db_block],
                    db_w[None, :, lo:lo + db_block],
                    mask[..., lo:lo + db_block])
                for lo in range(0, T, db_block)], dim=-1)

            norm = lcd_mod.normalize_scores(scores, nss[:, None, None],
                                            params)
            m, s, v = lcd_mod.top_islands(norm, params, C)  # (R, R, C)

            # temporal constraint on the best island per (query, target)
            gate, prev_island_new, consec_new = lcd_mod.temporal_gate(
                m[..., 0], v[..., 0], prev_island, consec, params)

            out_m[k], out_s[k], out_nss[k] = m, s, nss
            out_d[k] = v & gate[..., None] & kf_ok[:, None, None]

            # thread per-robot state only where this robot had a keyframe
            upd = kf_ok[:, None]
            prev_ids = torch.where(upd, ids_k, prev_ids)
            prev_w = torch.where(upd, w_k, prev_w)
            prev_ok = prev_ok | kf_ok
            prev_island = torch.where(upd, prev_island_new,
                                      prev_island).to(torch.int32)
            consec = torch.where(upd, consec_new, consec).to(torch.int32)

        return (DetectOutputs(match=out_m, score=out_s, detected=out_d,
                              nss=out_nss), (db_ids, db_w, db_valid))

    return detect_all


def make_verifier(cfg: FrontendConfig, device="cuda"):
    """Builds `verify_many` for one configuration. It runs on the card
    unless the caller passes device="cpu"; asking for a card where there
    is none raises."""
    mono_fn = (ransac.ransac_essential_5pt if cfg.use_5pt
               else ransac.ransac_essential)
    dev = backend.resolve_device(device)

    def _index(x):
        return torch.as_tensor(x).to(device=dev, dtype=torch.long)

    @torch.no_grad()
    def verify_many(base_key, desc_store, obs_store, bear_store, lm_store,
                    qr, qf, tr, tm):
        """Verify C candidates (query robot qr / frame qf against target
        robot tr / frame tm, each (C,) integers).

        base_key: (2,) threefry key (core/rng.py). desc_store
        (R, T, K, 32) uint8, obs_store (R, T, K) bool, bear_store /
        lm_store (R, T, 3, K) f32 coordinate-major, all on `device`.
        Returns mono_ok, stereo_ok (C,) bool; mono_inliers,
        stereo_inliers (C,) int32; R (C, 3, 3), t (C, 3): the pose of the
        target frame expressed in the query frame."""
        for name, s in (("desc_store", desc_store), ("obs_store", obs_store),
                        ("bear_store", bear_store), ("lm_store", lm_store)):
            if s.device.type != dev.type:
                raise ValueError(f"{name} lies on {s.device}, the verifier "
                                 f"was made for {dev}")
        qr, qf, tr, tm = _index(qr), _index(qf), _index(tr), _index(tm)
        base_key = base_key.to(dev)
        dq, vq = desc_store[qr, qf], obs_store[qr, qf]
        dm, vm = desc_store[tr, tm], obs_store[tr, tm]
        m, _ = hamming.knn2_lowe_match_pairs(dq, vq, dm, vm,
                                             lowe_ratio=cfg.lowe_ratio)

        keys = rngmod.derive(base_key, qr, qf, tr, tm)  # (C, 2)
        matched = m >= 0
        idx = torch.clamp(m, min=0)
        bq, lq = bear_store[qr, qf], lm_store[qr, qf]
        bm_m = gather.permute_cols(bear_store[tr, tm], idx)
        lm_m = gather.permute_cols(lm_store[tr, tm], idx)
        kmono = rngmod.derive(keys, rngmod.Stream.RANSAC_MONO)
        mono = mono_fn(
            kmono, bq, bm_m, matched,
            threshold=cfg.mono_threshold, n_hyp=cfg.ransac_hyp,
            min_inliers=cfg.min_mono_inliers)
        kst = rngmod.derive(keys, rngmod.Stream.RANSAC_STEREO)
        st = ransac.ransac_arun(
            kst, lq, lm_m, matched,
            threshold=cfg.stereo_threshold, n_hyp=cfg.ransac_hyp,
            min_inliers=cfg.min_stereo_inliers)
        R_qm, t_qm = lie.se3_inverse(st["R"], st["t"])
        return {"mono_ok": mono["ok"], "stereo_ok": st["ok"],
                "mono_inliers": mono["n_inliers"],
                "stereo_inliers": st["n_inliers"],
                "R": R_qm, "t": t_qm}

    return verify_many


class BatchedFrontend:
    """The front-end over a whole recorded or simulated run: BoW vectors of
    every keyframe, the detection loop, one host round-trip to compact the
    detections, verification in fixed-size chunks. Fills `loops` (accepted)
    and `lcd_attempts` (every verified candidate) with `VerifiedLC`
    records in the sequential path's order. Runs on the card unless the
    caller passes device="cpu"."""

    def __init__(self, n_robots: int, n_steps: int, vocab,
                 cfg: FrontendConfig, n_candidates: int = 1,
                 verify_chunk: int = 1024, db_block: int | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.n_robots = n_robots
        self.n_steps = n_steps
        self.device = backend.resolve_device(device)
        self.vocab = vocab.to(self.device)
        self.n_candidates = n_candidates
        self.verify_chunk = verify_chunk
        # frames per vocabulary-transform call: bounds the (frames, K, k,
        # 32) XOR intermediate (256 x 704 x 8 x 32 B = 46 MB at k = 8)
        self.bow_frames = 256
        self.loops: list[VerifiedLC] = []
        self.lcd_attempts: list[VerifiedLC] = []
        self.bow_overflow = 0
        self.stats: dict = {}
        self._detect = make_detector(n_robots, n_steps, cfg, n_candidates,
                                     db_block=db_block, device=self.device)
        self._verify = make_verifier(cfg, device=self.device)

    def _tensor(self, x, dtype):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    @torch.no_grad()
    def _bow_all(self, desc, valid):
        """(R, T, K, 32) descriptors -> packed BoW of every frame: ids,
        weights (R, T, W), sorted query copies, overflow (R, T)."""
        R, T, K = valid.shape
        W = self.cfg.bow_capacity
        d, v = desc.reshape(R * T, K, 32), valid.reshape(R * T, K)
        parts = []
        for lo in range(0, R * T, self.bow_frames):
            sl = slice(lo, lo + self.bow_frames)
            words = vocab_mod.transform(self.vocab, d[sl], v[sl])
            parts.append(vocab_mod.bow_from_words(
                words, self.vocab.word_weights, W))
        ids, weights, ovf = (torch.cat(x).reshape(R, T, *x[0].shape[1:])
                             for x in zip(*parts))
        qids, qw = bow_kernel.sort_bow(ids, weights)
        return ids, weights, qids, qw, ovf

    def compute_bows(self, descriptors, obs_valid):
        """Packed BoW vectors for every frame (ids, weights, sorted query
        copies as numpy arrays, and the overflow count) — the locally
        computable half that a pod streams to its peers."""
        ids, weights, qids, qw, ovf = self._bow_all(
            self._tensor(descriptors, torch.uint8),
            self._tensor(obs_valid, torch.bool))
        return (ids.cpu().numpy(), weights.cpu().numpy(),
                qids.cpu().numpy(), qw.cpu().numpy(), int(ovf.sum()))

    def detect_candidates(self, descriptors=None, obs_valid=None,
                          query_robots=None, bows=None, kf_valid=None):
        """DETECT phase: BoW scoring loop + candidate compaction.

        Either raw `descriptors` / `obs_valid` (BoW vectors computed here)
        or precomputed `bows` = (ids, weights) (R, T, W) with `kf_valid`
        (R, T) — the path where remote robots' BoW vectors arrived over the
        wire and their descriptors are not at hand.

        Stores the compacted candidate list and returns (rr, kk, tt, mm):
        query robot, query frame, target robot, target frame."""
        t0 = time.perf_counter()
        if bows is not None:
            ids = self._tensor(bows[0], torch.int32)
            weights = self._tensor(bows[1], torch.float32)
            qids, qw = bow_kernel.sort_bow(ids, weights)
            kf_valid = np.asarray(kf_valid)
        else:
            ov = self._tensor(obs_valid, torch.bool)
            ids, weights, qids, qw, ovf = self._bow_all(
                self._tensor(descriptors, torch.uint8), ov)
            kf_valid = ov.any(dim=-1).cpu().numpy()
            self.bow_overflow = int(ovf.sum())
        t1 = time.perf_counter()
        out, _db = self._detect(ids, weights, qids, qw, kf_valid)
        det = out.detected.cpu().numpy()
        match = out.match.cpu().numpy()
        score = out.score.cpu().numpy()
        t2 = time.perf_counter()

        # the single host round-trip: detected candidates in the sequential
        # path's (step, robot, target, candidate) order
        kk, rr, tt, cc = np.nonzero(det)
        if query_robots is not None:
            keep = np.isin(rr, np.asarray(sorted(query_robots)))
            kk, rr, tt, cc = kk[keep], rr[keep], tt[keep], cc[keep]
        order = np.lexsort((cc, tt, rr, kk))
        kk, rr, tt, cc = kk[order], rr[order], tt[order], cc[order]
        mm = match[kk, rr, tt, cc]
        ss = score[kk, rr, tt, cc]
        self._cand = (kk, rr, tt, mm, ss)
        t3 = time.perf_counter()
        self.stats.update(n_keyframes=int(kf_valid.sum()),
                          n_candidates=len(kk), t_detect=t3 - t0,
                          t_bow=t1 - t0, t_scan=t2 - t1, t_compact=t3 - t2)
        return rr, kk, tt, mm

    @torch.no_grad()
    def verify_candidates(self, descriptors, bearings, landmarks,
                          obs_valid):
        """VERIFY phase over the candidates of `detect_candidates`. The
        stores hold every frame's data: descriptors (R, T, K, 32) uint8,
        bearings / landmarks (R, T, K, 3), obs_valid (R, T, K)."""
        kk, rr, tt, mm, ss = self._cand
        B = len(kk)
        if B == 0:
            self.stats.update(t_verify=0.0, verifications_per_s=0.0)
            return self.stats
        cfg = self.cfg
        desc = self._tensor(descriptors, torch.uint8).contiguous()
        ov = self._tensor(obs_valid, torch.bool).contiguous()
        # one run-level relayout to the SoA keyframe stores (R, T, 3, K)
        bear = self._tensor(bearings, torch.float32).transpose(
            -1, -2).contiguous()
        lm = self._tensor(landmarks, torch.float32).transpose(
            -1, -2).contiguous()
        key = rngmod.base_key(cfg.base_seed, device=self.device)

        # fixed-size chunks bound the live (chunk, K) intermediates whatever
        # the number of candidates: the next power of two of the count, at
        # least 64 and at most verify_chunk (the last chunk zero-padded)
        chunk = min(self.verify_chunk,
                    max(64, int(2 ** np.ceil(np.log2(B)))))
        n_chunks = (B + chunk - 1) // chunk
        t1 = time.perf_counter()
        parts = []
        for ci in range(n_chunks):
            sl = slice(ci * chunk, min((ci + 1) * chunk, B))
            n = sl.stop - sl.start

            def padded(a):
                return np.concatenate([a[sl], np.zeros(chunk - n, a.dtype)])

            part = self._verify(key, desc, ov, bear, lm, padded(rr),
                                padded(kk), padded(tt), padded(mm))
            parts.append({k: v[:n].cpu().numpy() for k, v in part.items()})
        res = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        t_verify = time.perf_counter() - t1
        self.stats.update(
            t_verify=t_verify, verify_chunks=n_chunks,
            verify_chunk_size=chunk,
            verifications_per_s=(n_chunks * chunk) / max(t_verify, 1e-9))

        for i in range(B):
            mono_ok = bool(res["mono_ok"][i])
            stereo_ok = bool(res["stereo_ok"][i])
            status = lcd_status(mono_ok, stereo_ok)
            lc = VerifiedLC(
                robot_a=int(rr[i]), frame_a=int(kk[i]),
                robot_b=int(tt[i]), frame_b=int(mm[i]),
                R=res["R"][i], t=res["t"][i],
                mono_inliers=int(res["mono_inliers"][i]),
                stereo_inliers=int(res["stereo_inliers"][i]),
                bow_score=float(ss[i]), status=status,
                accepted=mono_ok and stereo_ok)
            self.lcd_attempts.append(lc)
            if lc.accepted:
                self.loops.append(lc)
        return self.stats

    def process_all(self, descriptors, bearings, landmarks, obs_valid,
                    query_robots=None):
        """The whole front-end over a recorded or simulated run:
        `detect_candidates` then `verify_candidates`.

        descriptors (R, T, K, 32) uint8; bearings / landmarks (R, T, K, 3);
        obs_valid (R, T, K). Fills `loops` / `lcd_attempts`; returns the
        timing stats. query_robots: verify only candidates whose query robot
        is in this set (how a pod takes its share of the verification)."""
        self.detect_candidates(descriptors, obs_valid,
                               query_robots=query_robots)
        return self.verify_candidates(descriptors, bearings, landmarks,
                                      obs_valid)

    def build_pose_graph(self, R_odo, t_odo, edge_capacity=None):
        """Odometry + the accepted loops as one PoseGraphEdges on the
        front-end's device (`dlc.build_pose_graph_from_loops`)."""
        return build_pose_graph_from_loops(
            self.loops, R_odo, t_odo, self.cfg, edge_capacity,
            device=self.device)
