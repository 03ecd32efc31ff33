"""The detection loop (`make_detector`) and the simulated world of the
port against the JAX package's, on the CPU: synthetic BoW streams with
realistic frame-to-frame overlap (as tests/test_detect_scale.py makes
them) and the BoW vectors of a small `make_world`; both temporal modes,
one and three candidates per (query robot, target robot); blocked
scoring against unblocked; the hand-built temporal-gate case of
tests/test_frontend_batched.py.

Tolerance: detections and match frames are compared exactly; island
scores and nss factors within rtol 1e-6 (the port accumulates sums in
float64, XLA in float32). The world's integers (descriptors, validity,
places) are equal; its floats within atol 1e-5 (the port's host
Rodrigues formula against `lie.so3_exp`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.frontend import batched as jb, dlc as jd, lcd as jl
from kimera_multi_tpu.io import sim_world as jw
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.frontend import batched as tb, dlc as td, lcd as tl
from kimera_multi_tpu_torch.frontend import vocab as tv
from kimera_multi_tpu_torch.io import sim_world as tw

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _synth_bows(R, T, W, n_words=400, seed=0):
    """Packed BoW streams whose consecutive frames share half their words
    (tests/test_detect_scale.py:_synth_bows)."""
    npr = np.random.default_rng(seed)
    ids = npr.integers(0, n_words, (R, T, W)).astype(np.int32)
    ids[:, 1:, : W // 2] = ids[:, :-1, : W // 2]
    weights = npr.uniform(0.1, 1.0, (R, T, W)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    order = np.argsort(ids, axis=-1)
    qids = np.take_along_axis(ids, order, axis=-1)
    qw = np.take_along_axis(weights, order, axis=-1)
    kf_valid = np.ones((R, T), bool)
    kf_valid[1, 5:9] = False  # a robot without keyframes for a while
    return ids, weights, qids, qw, kf_valid


@pytest.fixture(scope="module")
def world_bows():
    w = tw.make_world(n_robots=2, n_steps=30, features_per_kf=64, seed=1)
    corpus = w.descriptors[w.obs_valid].reshape(-1, 32)
    sub = corpus[:: max(1, len(corpus) // 4000)]
    voc = tv.build_vocabulary(sub, k=8, depth=3, seed=1, device="cpu")
    fe = tb.BatchedFrontend(2, 30, voc, td.FrontendConfig(), device="cpu")
    ids, weights, qids, qw, _ = fe.compute_bows(w.descriptors, w.obs_valid)
    return ids, weights, qids, qw, w.obs_valid.any(-1)


def _both(args, R, T, W, mtm, C, db_block=None, **lcd_kw):
    jcfg = jd.FrontendConfig(bow_capacity=W, lcd=jl.LcdParams(
        min_temporal_matches=mtm, **lcd_kw))
    ref, _ = jb.make_detector(R, T, jcfg, C, db_block=db_block)(
        *(jnp.asarray(a) for a in args))
    got, _ = tb.make_detector(R, T, convert.config_from_jax(jcfg), C,
                              db_block=db_block, device="cpu")(*args)
    return ref, got


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.detected.numpy(),
                                  np.asarray(ref.detected))
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(ref.match))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.nss.numpy(), np.asarray(ref.nss),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("mtm,C", [(1, 1), (2, 3)])
def test_make_detector_synth(mtm, C):
    R, T, W = 3, 40, 16
    args = _synth_bows(R, T, W, seed=3)
    ref, got = _both(args, R, T, W, mtm, C, recent_frames_window=10)
    _assert_same(ref, got)
    assert got.detected.shape == (T, R, R, C)
    assert int(got.detected.sum()) > 5


@pytest.mark.parametrize("mtm,C", [(1, 3), (2, 1)])
def test_make_detector_world(world_bows, mtm, C):
    ref, got = _both(world_bows, 2, 30, 128, mtm, C)
    _assert_same(ref, got)
    assert int(got.detected.sum()) > 10


def test_blocked_scoring_identical():
    """db_block reorganizes the same arithmetic: outputs are identical."""
    R, T, W = 3, 40, 16
    args = _synth_bows(R, T, W, seed=4)
    cfg = td.FrontendConfig(bow_capacity=W,
                            lcd=tl.LcdParams(recent_frames_window=10))
    full, db_full = tb.make_detector(R, T, cfg, 3, db_block=T,
                                     device="cpu")(*args)
    for blk in (16, 7):
        out, db = tb.make_detector(R, T, cfg, 3, db_block=blk,
                                   device="cpu")(*args)
        for a, b in zip(full, out):
            assert torch.equal(a, b)
        for a, b in zip(db_full, db):
            assert torch.equal(a, b)


def test_temporal_constraint_gates_detections():
    """A one-off match is gated until it is temporally confirmed
    min_temporal_matches times (tests/test_frontend_batched.py)."""
    R, T, W = 2, 6, 16
    ids = np.full((R, T, W), -1, np.int32)
    weights = np.zeros((R, T, W), np.float32)
    for k in range(T):
        ids[0, k, 0] = 5
        weights[0, k, 0] = 1.0
        ids[1, k, 0] = 5 if k >= 2 else 9
        weights[1, k, 0] = 1.0
    kf_valid = np.ones((R, T), bool)
    qids = np.where(ids >= 0, ids, 2 ** 30)

    def detected(mtm):
        cfg = td.FrontendConfig(bow_capacity=W, lcd=tl.LcdParams(
            min_temporal_matches=mtm, recent_frames_window=2, alpha=0.1))
        out, _ = tb.make_detector(R, T, cfg, device="cpu")(
            ids, weights, qids, weights, kf_valid)
        return out.detected.numpy()[:, 1, 0, 0]  # robot 1 vs robot 0's DB

    det = detected(2)
    # frame 2: nss 0 (the previous BoW shares no word) -> no match;
    # frame 3: first consistent match -> gated; frame 4 on: confirmed
    assert not det[2] and not det[3]
    assert det[4] and det[5]
    assert detected(1)[3]


def test_make_world_matches_jax():
    ref = jw.make_world(n_robots=3, n_steps=25, features_per_kf=32, seed=2)
    got = tw.make_world(n_robots=3, n_steps=25, features_per_kf=32, seed=2)
    for f in ("descriptors", "obs_valid", "place_of_kf"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    for f in ("R_gt", "t_gt", "timestamps", "R_odo", "t_odo",
              "landmarks_local", "bearings_local"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
    assert (got.n_robots, got.n_steps) == (3, 25)
    assert (got.place_of_kf >= 0).all()
