"""The general generator of loop-closure candidate backlogs: it reads a
traffic file's parameters and draws, from a seed, the candidate pairs a
fleet hands to verification after a burst of detections.

A candidate is (query robot qr, query frame qf, target robot tr, target
frame tm), the target frame always at an earlier step, and at least
`same_robot_gap` frames earlier on the query's own robot (the detector's
recent-frames window). `same_place` of the pairs join keyframes that see
one place, the rest keyframes of different places; every seed gets
exactly these counts in the same sequence of kinds (so each chunk holds
its share of both), with other pairs. The pass is cut into chunks of
`chunk` candidates, the last one zero-padded, as the front-end's
`verify_candidates` cuts its list.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .world import World


class Backlog(NamedTuple):
    qr: np.ndarray  # (B,) int64
    qf: np.ndarray
    tr: np.ndarray
    tm: np.ndarray
    same_place: np.ndarray  # (B,) bool, ground truth of the pair
    chunk: int

    @property
    def n(self) -> int:
        return len(self.qr)

    @property
    def n_chunks(self) -> int:
        return -(-self.n // self.chunk)

    def chunk_arrays(self, i: int):
        """Chunk i as four (chunk,) int64 arrays, zero-padded, and the
        number of real candidates in it."""
        lo = i * self.chunk
        hi = min(lo + self.chunk, self.n)
        out = []
        for a in (self.qr, self.qf, self.tr, self.tm):
            x = np.zeros(self.chunk, np.int64)
            x[:hi - lo] = a[lo:hi]
            out.append(x)
        return out, hi - lo


def _draw(npr, world: World, n: int, same: bool, gap: int, taken: set):
    place = world.place_of_kf
    R, T = place.shape
    seen = place >= 0
    qs = np.argwhere(seen)
    out = []
    while len(out) < n:
        m = 4 * (n - len(out)) + 64
        q = qs[npr.integers(0, len(qs), m)]
        tr = npr.integers(0, R, m)
        for (qr, qf), t in zip(q, tr):
            hi = qf - gap + 1 if t == qr else qf
            if hi <= 0:
                continue
            cand = place[t, :hi]
            ok = (cand == place[qr, qf]) if same else (
                (cand >= 0) & (cand != place[qr, qf]))
            frames = np.flatnonzero(ok)
            if len(frames) == 0:
                continue
            tm = int(frames[npr.integers(0, len(frames))])
            key = (int(qr), int(qf), int(t), tm)
            if key in taken:
                continue
            taken.add(key)
            out.append(key)
            if len(out) == n:
                break
    return out


def make_backlog(world: World, traffic: dict, seed: int) -> Backlog:
    """The backlog of `seed` over `world` for a traffic file's parameters
    (`candidates`, `same_place`, `same_robot_gap`, `chunk`)."""
    n, n_same = int(traffic["candidates"]), int(traffic["same_place"])
    if not 0 <= n_same <= n:
        raise ValueError("same_place must lie in 0..candidates")
    gap = int(traffic["same_robot_gap"])
    npr = np.random.default_rng([seed, 1])
    taken: set = set()
    pairs = (_draw(npr, world, n_same, True, gap, taken)
             + _draw(npr, world, n - n_same, False, gap, taken))
    # every seed gets the same sequence of kinds, so every chunk holds its
    # share of same-place pairs: position i is a same-place pair where
    # floor((i + 1) p) steps past floor(i p), p = same_place / candidates;
    # which pairs fill the positions is shuffled
    i = np.arange(n, dtype=np.int64)
    same = (i + 1) * n_same // n > i * n_same // n
    arr = np.empty((n, 4), np.int64)
    arr[same] = np.asarray(pairs[:n_same], np.int64).reshape(-1, 4)[
        npr.permutation(n_same)]
    arr[~same] = np.asarray(pairs[n_same:], np.int64).reshape(-1, 4)[
        npr.permutation(n - n_same)]
    return Backlog(arr[:, 0].copy(), arr[:, 1].copy(), arr[:, 2].copy(),
                   arr[:, 3].copy(), same, int(traffic["chunk"]))
