"""BoW scoring and the BoW database of the port against the JAX package's,
on the CPU, on shared numpy inputs.

Tolerance: word ids and orders are integers and must be equal; float32
scores and weights within rtol 1e-6. The port accumulates weight sums in
float64 (rounded once to float32) where XLA sums in float32, so the two
can differ in the last bits, never more."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.frontend import bow_db as jdb
from kimera_multi_tpu.kernels import bow as jbow
from kimera_multi_tpu_torch.frontend import bow_db as tdb
from kimera_multi_tpu_torch.kernels import bow as tbow

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _bows(n, W, n_words=200, seed=0, pad_frac=0.3):
    """n padded BoW vectors of W slots: distinct ids per vector, -1 padding
    in random slots, L1-normalized weights."""
    rs = np.random.default_rng(seed)
    ids = np.stack([rs.permutation(n_words)[:W] for _ in range(n)])
    ids = ids.astype(np.int32)
    ids[rs.uniform(size=(n, W)) < pad_frac] = -1
    w = rs.uniform(0.05, 1.0, (n, W)).astype(np.float32)
    w = np.where(ids >= 0, w, 0.0).astype(np.float32)
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-12)
    return ids, w.astype(np.float32)


def test_sort_bow():
    ids, w = _bows(6, 32, seed=1)
    for i in range(6):
        ji, jw = jbow.sort_bow(jnp.asarray(ids[i]), jnp.asarray(w[i]))
        ti, tw = tbow.sort_bow(torch.from_numpy(ids[i]),
                               torch.from_numpy(w[i]))
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    # batched over leading axes, the same rows
    bi, bw = tbow.sort_bow(torch.from_numpy(ids), torch.from_numpy(w))
    ji, jw = jbow.sort_bow(jnp.asarray(ids[3]), jnp.asarray(w[3]))
    np.testing.assert_array_equal(np.asarray(ji), bi[3].numpy())
    np.testing.assert_array_equal(np.asarray(jw), bw[3].numpy())


@pytest.mark.parametrize("n_words", [40, 400])
def test_l1_scores(n_words):
    """Overlapping vocabularies (n_words = 40: most words shared) and
    sparse ones; invalid frames score 0."""
    ids, w = _bows(9, 24, n_words=n_words, seed=2)
    q_ids, q_w = ids[0], w[0]
    db_ids, db_w = ids[1:], w[1:]
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    jq, jqw = jbow.sort_bow(jnp.asarray(q_ids), jnp.asarray(q_w))
    ref = np.asarray(jbow.l1_scores(jq, jqw, jnp.asarray(db_ids),
                                    jnp.asarray(db_w), jnp.asarray(valid)))
    tq, tqw = tbow.sort_bow(torch.from_numpy(q_ids), torch.from_numpy(q_w))
    got = tbow.l1_scores(tq, tqw, torch.from_numpy(db_ids),
                         torch.from_numpy(db_w), torch.from_numpy(valid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (got.numpy()[~valid] == 0).all() and got.numpy()[valid].max() > 0
    # the database against itself scores 1
    own = tbow.l1_scores(*tbow.sort_bow(torch.from_numpy(db_ids[:1]),
                                        torch.from_numpy(db_w[:1])),
                         torch.from_numpy(db_ids[None, :1]),
                         torch.from_numpy(db_w[None, :1]),
                         torch.ones(1, 1, dtype=torch.bool))
    np.testing.assert_allclose(own.numpy(), [[1.0]], rtol=1e-6)


def test_nss_normalized_scores():
    s = np.array([0.0, 0.1, 0.3, 0.7], np.float32)
    for f in (0.01, 0.05, 0.2, 1.0):
        ref = np.asarray(jbow.nss_normalized_scores(jnp.asarray(s),
                                                    jnp.float32(f)))
        got = tbow.nss_normalized_scores(torch.from_numpy(s), f)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_normalize_l1():
    _, w = _bows(5, 20, seed=4)
    valid = np.random.default_rng(4).uniform(size=(5, 20)) < 0.6
    valid[2] = False  # nothing valid: all zero, no division by zero
    for i in range(5):
        ref = np.asarray(jbow.normalize_l1(jnp.asarray(w[i]),
                                           jnp.asarray(valid[i])))
        got = tbow.normalize_l1(torch.from_numpy(w[i]),
                                torch.from_numpy(valid[i]))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (got.numpy()[~valid[4]] == 0).all()


def test_default_device_is_the_card():
    """The database lies on the card unless the caller asks for the CPU;
    with no card, asking for it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert tdb.empty(4, 8).word_ids.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdb.empty(4, 8)
    assert tdb.empty(4, 8, device="cpu").weights.device.type == "cpu"


def test_bow_db_query():
    ids, w = _bows(12, 16, n_words=60, seed=3)
    jd, td = jdb.empty(10, 16), tdb.empty(10, 16, device="cpu")
    for f in (0, 2, 3, 4, 7, 9):
        jd = jdb.add(jd, jnp.int32(f), jnp.asarray(ids[f]),
                     jnp.asarray(w[f]))
        td = tdb.add(td, f, torch.from_numpy(ids[f]),
                     torch.from_numpy(w[f]))
    assert int(td.count) == int(jd.count) == 10
    np.testing.assert_array_equal(np.asarray(jd.word_ids), td.word_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jd.frame_valid),
                                  td.frame_valid.numpy())
    jq = jbow.sort_bow(jnp.asarray(ids[11]), jnp.asarray(w[11]))
    tq = tbow.sort_bow(torch.from_numpy(ids[11]), torch.from_numpy(w[11]))
    for excl in (None, 4):
        ref = np.asarray(jdb.query(jd, *jq, exclude_after=excl))
        got = tdb.query(td, *tq, exclude_after=excl)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (got.numpy()[4:] == 0).all()
