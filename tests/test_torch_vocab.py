"""The BoW vocabulary of the port against the JAX package's, on the CPU:
building (hierarchical binary k-means), the word assignment, BoW vectors
from words, the DBoW2 YAML loader, and a vocabulary carried across from
the JAX package with `convert.vocabulary_from_numpy`.

Tolerance: centroids, validity, word ids and overflow counts are integers
and must be equal; idf weights equal (the same numpy code computes them);
BoW weights within rtol 1e-6 (the port sums in float64, XLA in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.frontend import dlc as jdlc, lcd as jlcd
from kimera_multi_tpu.frontend import vocab as jv
from kimera_multi_tpu.io import sim_world as jw
from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.frontend import vocab as tv
from kimera_multi_tpu_torch.kernels import bow as bow_kernel

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world_vocabs():
    w = jw.make_world(n_robots=2, n_steps=30, features_per_kf=64, seed=1)
    corpus = w.descriptors[w.obs_valid].reshape(-1, 32)
    sub = corpus[:: max(1, len(corpus) // 4000)]
    return (w, jv.build_vocabulary(sub, k=8, depth=3, seed=1),
            tv.build_vocabulary(sub, k=8, depth=3, seed=1, device="cpu"))


def _assert_same_vocab(jvoc, tvoc):
    assert (tvoc.k, tvoc.depth) == (jvoc.k, jvoc.depth)
    for a, b in zip(jvoc.centroids, tvoc.centroids):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jvoc.node_valid, tvoc.node_valid):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jvoc.word_weights),
                                  tvoc.word_weights.numpy())


def _jax_words(jvoc, desc, valid):
    return np.asarray(jax.jit(lambda d, v: jv.transform(jvoc, d, v))(
        jnp.asarray(desc), jnp.asarray(valid)))


def test_build_vocabulary(world_vocabs):
    _, jvoc, tvoc = world_vocabs
    _assert_same_vocab(jvoc, tvoc)
    assert tvoc.node_valid[-1].sum() > 100 and tvoc.n_words == 512


def test_transform(world_vocabs):
    w, jvoc, tvoc = world_vocabs
    desc = w.descriptors.reshape(-1, 64, 32)
    valid = w.obs_valid.reshape(-1, 64).copy()
    valid[::3, 50:] = False
    ref = np.stack([_jax_words(jvoc, d, v) for d, v in zip(desc[:8],
                                                           valid[:8])])
    got = tv.transform(tvoc, torch.from_numpy(desc[:8]),
                       torch.from_numpy(valid[:8]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    # every frame, batched, against the flat descriptor list
    flat = _jax_words(jvoc, desc.reshape(-1, 32), valid.reshape(-1))
    got = tv.transform(tvoc, torch.from_numpy(desc), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy().reshape(-1), flat)


@pytest.mark.parametrize("capacity", [16, 40, 128])
def test_bow_from_words(world_vocabs, capacity):
    """capacity < distinct words (overflow counted), about as many, and
    capacity > K (padding)."""
    w, jvoc, tvoc = world_vocabs
    desc = w.descriptors.reshape(-1, 64, 32)[:6]
    valid = np.ones((6, 64), bool)
    valid[1, 10:] = False
    valid[2] = False
    words = np.stack([_jax_words(jvoc, d, v) for d, v in zip(desc, valid)])
    f = jax.jit(lambda x: jv.bow_from_words(x, jvoc.word_weights, capacity))
    tids, tw, tovf = tv.bow_from_words(torch.from_numpy(words),
                                       tvoc.word_weights, capacity)
    assert tids.shape == (6, capacity) and tovf.dtype == torch.int32
    for i in range(6):
        ji, jwt, jovf = (np.asarray(x) for x in f(jnp.asarray(words[i])))
        np.testing.assert_array_equal(tids[i].numpy(), ji)
        assert int(tovf[i]) == int(jovf)
        np.testing.assert_allclose(tw[i].numpy(), jwt, rtol=1e-6, atol=0)
    if capacity == 16:
        assert int(tovf.max()) > 0


def test_bow_weight_span_keeps_sums_exact(world_vocabs):
    """The float64 sums of kernels/bow.py are exact (so independent of
    their order, on the card as on the CPU) while a BoW vector's nonzero
    weights span less than 2^22. The world's vectors stay inside it, and
    a reversed summation order gives the same bits."""
    w, _, tvoc = world_vocabs
    R, T, K = w.obs_valid.shape
    words = tv.transform(tvoc, torch.from_numpy(w.descriptors).reshape(
        R * T, K, 32), torch.from_numpy(w.obs_valid).reshape(R * T, K))
    ids, wts, _ = tv.bow_from_words(words, tvoc.word_weights, 128)
    nz = wts > 0
    hi = torch.where(nz, wts, 0.0).amax(-1)
    lo = torch.where(nz, wts, torch.inf).amin(-1)
    has = nz.any(-1)
    assert has.sum() > 0
    assert float((hi[has] / lo[has]).max()) < 2.0 ** 22
    flipped = bow_kernel.sum_f32(wts.flip(-1))
    assert torch.equal(bow_kernel.sum_f32(wts), flipped)


def test_default_device_is_the_card():
    """A built vocabulary lies on the card unless the caller asks for the
    CPU; with no card, asking for it raises instead of running on the
    CPU."""
    desc = np.random.default_rng(2).integers(0, 256, (64, 32), np.uint8)
    if torch.cuda.is_available():
        voc = tv.build_vocabulary(desc, k=2, depth=2)
        assert voc.word_weights.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tv.build_vocabulary(desc, k=2, depth=2)
    voc = tv.build_vocabulary(desc, k=2, depth=2, device="cpu")
    assert all(c.device.type == "cpu" for c in voc.centroids)


def _write_dbow2_tree(path, seed=42, k=10, depth=4):
    """A ragged DBoW2 OpenCV-YAML vocabulary as tests/test_vocab_dbow2.py
    builds its fixture: >= 10^4 nodes, ids relabeled by a random
    permutation, entries shuffled, ~1 % of branches ending early."""
    rng = np.random.default_rng(seed)
    nodes, children, next_id, frontier = {}, {}, 1, [0]
    for lvl in range(depth):
        new_frontier = []
        for pid in frontier:
            if lvl >= 1 and pid != 0 and rng.uniform() < 0.01:
                continue
            n_kids = k if lvl < 2 else int(rng.integers(10, 11))
            for _ in range(n_kids):
                nid = next_id
                next_id += 1
                desc = rng.integers(0, 256, 32, dtype=np.uint8)
                wt = float(rng.uniform(0.5, 3.0)) if lvl == depth - 1 else 0.0
                nodes[nid] = (pid, wt, desc)
                children.setdefault(pid, []).append(nid)
                new_frontier.append(nid)
        frontier = new_frontier
    for nid, (pid, wt, desc) in list(nodes.items()):
        if nid not in children and wt == 0.0:
            nodes[nid] = (pid, float(rng.uniform(0.5, 3.0)), desc)
    perm = rng.permutation(len(nodes)) + 1
    relabel = {0: 0}
    for i, nid in enumerate(sorted(nodes)):
        relabel[nid] = int(perm[i])
    nodes_r = {relabel[n]: (relabel[p], wt, d)
               for n, (p, wt, d) in nodes.items()}
    children_r = {relabel[p] for p in children}
    entries = [f"      - {{ nodeId:{nid}, parentId:{pid}, weight:{wt:.6e}, "
               f"descriptor:\"{' '.join(str(int(x)) for x in d)} \" }}"
               for nid, (pid, wt, d) in nodes_r.items()]
    rng.shuffle(entries)
    leaves = sorted(n for n in nodes_r if n not in children_r)
    words = [f"      - {{ wordId:{i}, nodeId:{n} }}"
             for i, n in enumerate(leaves)]
    path.write_text(
        "%YAML:1.0\n---\nvocabulary:\n"
        f"   k: {k}\n   L: {depth}\n   scoringType: 0\n   weightingType: 0\n"
        "   nodes:\n" + "\n".join(entries) + "\n   words:\n"
        + "\n".join(words) + "\n")
    return len(nodes)


def test_load_dbow2_yml(tmp_path):
    path = tmp_path / "voc.yml"
    assert _write_dbow2_tree(path) >= 10_000
    jvoc = jv.load_dbow2_yml(str(path))
    tvoc = tv.load_dbow2_yml(str(path), device="cpu")
    _assert_same_vocab(jvoc, tvoc)
    rs = np.random.default_rng(5)
    desc = rs.integers(0, 256, (300, 32), dtype=np.uint8)
    valid = np.ones(300, bool)
    np.testing.assert_array_equal(
        tv.transform(tvoc, torch.from_numpy(desc),
                     torch.from_numpy(valid)).numpy(),
        _jax_words(jvoc, desc, valid))


def test_vocabulary_and_config_from_jax(world_vocabs):
    """A JAX vocabulary carried across as numpy gives the same words; the
    detection parameters ride along with the configuration."""
    w, jvoc, _ = world_vocabs
    voc = convert.vocabulary_from_numpy(
        jvoc.k, jvoc.depth, [np.asarray(c) for c in jvoc.centroids],
        np.asarray(jvoc.word_weights),
        [np.asarray(v) for v in jvoc.node_valid], device="cpu")
    _assert_same_vocab(jvoc, voc)
    desc = w.descriptors.reshape(-1, 32)[:500]
    valid = np.ones(500, bool)
    np.testing.assert_array_equal(
        tv.transform(voc, torch.from_numpy(desc),
                     torch.from_numpy(valid)).numpy(),
        _jax_words(jvoc, desc, valid))
    with pytest.raises(ValueError):
        convert.vocabulary_from_numpy(8, 3, [np.asarray(c) for c in
                                             jvoc.centroids[:2]],
                                      np.asarray(jvoc.word_weights),
                                      [np.asarray(v) for v in jvoc.node_valid])
    jcfg = jdlc.FrontendConfig(lcd=jlcd.LcdParams(min_temporal_matches=3,
                                                  alpha=0.2))
    tcfg = convert.config_from_jax(jcfg)
    assert tcfg.lcd.min_temporal_matches == 3 and tcfg.lcd.alpha == 0.2
    assert tuple(tcfg.lcd) == tuple(jcfg.lcd)
