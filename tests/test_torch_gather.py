"""The port's sample gathers against the JAX package's (XLA path and the
Pallas kernels in interpret mode) on shared numpy inputs. On the CPU the
port takes the plain (advanced-indexing) version of its CUDA kernels.
Tolerance: none — a gather copies values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.kernels import gather as jg, ransac as jr
from kimera_multi_tpu_torch.kernels import gather as tg, ransac as tr

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _inputs(k, C=3, K=75, H=40, seed=0):
    rs = np.random.default_rng(seed)
    data = rs.normal(size=(C, 3, K)).astype(np.float32)
    picks = rs.integers(0, K, (C, H, k)).astype(np.int32)
    order = np.stack([rs.permutation(K) for _ in range(C)]).astype(np.int32)
    inv = np.argsort(order, axis=1).astype(np.int32)
    return data, picks, order, inv


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("interpret", [False, True])
def test_sample_gather_perm_t(k, interpret):
    data, picks, order, inv = _inputs(k)
    out = tg.sample_gather_perm_t(*(torch.from_numpy(x) for x in
                                    (data, picks, order, inv)))
    assert tuple(out.shape) == (3, k * 3, 40) and out.dtype == torch.float32
    for c in range(data.shape[0]):
        ref = jg.sample_gather_perm_t(
            jnp.asarray(data[c]), jnp.asarray(picks[c]),
            jnp.asarray(order[c]), jnp.asarray(inv[c]), interpret=interpret)
        np.testing.assert_array_equal(np.asarray(ref), out[c].numpy())
    # the definition itself
    c, m, i, h = 1, k - 1, 2, 7
    assert out[c, m * 3 + i, h] == data[c, i, order[c, picks[c, h, m]]]


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("interpret", [False, True])
def test_sample_gather_t(k, interpret):
    data, picks, _, _ = _inputs(k, seed=3)
    out = tg.sample_gather_t(torch.from_numpy(data), torch.from_numpy(picks))
    assert tuple(out.shape) == (3, k * 3, 40) and out.dtype == torch.float32
    for c in range(data.shape[0]):
        ref = jg.sample_gather_t(jnp.asarray(data[c]), jnp.asarray(picks[c]),
                                 interpret=interpret)
        np.testing.assert_array_equal(np.asarray(ref), out[c].numpy())
    c, m, i, h = 2, k - 1, 1, 11
    assert out[c, m * 3 + i, h] == data[c, i, picks[c, h, m]]


def test_gather_samples_matches_jax():
    data, picks, _, _ = _inputs(5, seed=4)
    got = tr._gather_samples(torch.from_numpy(data), torch.from_numpy(picks))
    for c in range(data.shape[0]):
        ref = jr._gather_samples(jnp.asarray(data[c]), jnp.asarray(picks[c]))
        for m in range(5):
            for i in range(3):
                np.testing.assert_array_equal(np.asarray(ref[m][i]),
                                              got[m][i][c].numpy())


@pytest.mark.parametrize("Kin,Kout", [(75, 75), (96, 70)])
@pytest.mark.parametrize("interpret", [False, True])
def test_permute_cols(Kin, Kout, interpret):
    rs = np.random.default_rng(2)
    C = 3
    data = rs.normal(size=(C, 3, Kin)).astype(np.float32)
    idx = rs.integers(0, Kin, (C, Kout)).astype(np.int32)
    out = tg.permute_cols(torch.from_numpy(data), torch.from_numpy(idx))
    assert tuple(out.shape) == (C, 3, Kout)
    for c in range(C):
        if Kin == Kout or not interpret:
            # the Pallas kernel takes square (K, K) one-hot operands only
            ref = jg.permute_cols(jnp.asarray(data[c]), jnp.asarray(idx[c]),
                                  interpret=interpret and Kin == Kout)
            np.testing.assert_array_equal(np.asarray(ref), out[c].numpy())
        np.testing.assert_array_equal(data[c][:, idx[c]], out[c].numpy())


def test_out_of_range_indices_are_clamped():
    """Indices outside [0, K) are outside the contract (the JAX package's
    XLA path wraps negative ones and its Pallas path returns zeros); the
    port clamps them, so that a kernel never reads outside its block."""
    data, picks, order, inv = _inputs(3)
    K = data.shape[2]
    idx = np.tile(np.arange(K, dtype=np.int32), (3, 1))
    idx[0, 0], idx[1, 5], idx[2, -1] = -3, K, K + 50
    out = tg.permute_cols(torch.from_numpy(data), torch.from_numpy(idx))
    for c in range(3):
        np.testing.assert_array_equal(
            data[c][:, np.clip(idx[c], 0, K - 1)], out[c].numpy())
    picks[0, 0, 0], picks[1, 2, 1] = -1, K + 7
    out = tg.sample_gather_perm_t(*(torch.from_numpy(x) for x in
                                    (data, picks, order, inv)))
    assert out[0, 0, 0] == data[0, 0, order[0, 0]]
    assert out[1, 3 + 2, 2] == data[1, 2, order[1, K - 1]]
    out = tg.sample_gather_t(torch.from_numpy(data), torch.from_numpy(picks))
    assert out[0, 0, 0] == data[0, 0, 0]
    assert out[1, 3 + 2, 2] == data[1, 2, K - 1]
