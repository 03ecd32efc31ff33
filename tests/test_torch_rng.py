"""The port's threefry RNG (kimera_multi_tpu_torch/core/rng.py) against
jax.random: keys and draws must be BIT-equal, since RANSAC sample tables
decide integers downstream. Tolerance: none (exact equality)."""

import jax
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import rng as jrng
from kimera_multi_tpu_torch.core import rng as trng

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _jax_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**32 - 1])
def test_base_key_words(seed):
    np.testing.assert_array_equal(_jax_words(jrng.base_key(seed)),
                                  trng.base_key(seed).numpy())


@pytest.mark.parametrize("ids", [
    (0,), (3, 1000, 2, 5), (5, 1023, 0, 1, int(jrng.Stream.RANSAC_STEREO)),
    (2**31, 2**32 - 1), (int(jrng.Stream.RANSAC_MONO),),
])
def test_derive_bit_equal(ids):
    kj = jrng.derive(jrng.base_key(11), *ids)
    kt = trng.derive(trng.base_key(11), *ids)
    np.testing.assert_array_equal(_jax_words(kj), kt.numpy())


def test_stream_tags_equal():
    assert {s.name: int(s) for s in jrng.Stream} == \
        {s.name: int(s) for s in trng.Stream}


@pytest.mark.parametrize("shape", [(1,), (500, 8), (64, 3), (7, 5, 2)])
def test_uniform_bit_equal(shape):
    kj = jrng.derive(jrng.base_key(3), 4, 2)
    kt = trng.derive(trng.base_key(3), 4, 2)
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = trng.uniform(kt, shape)
    assert ut.dtype == torch.float32 and tuple(ut.shape) == shape
    np.testing.assert_array_equal(uj, ut.numpy())
    assert (ut >= 0).all() and (ut < 1).all()


def test_batched_keys_match_vmap():
    """A batch of keys derived from index tensors equals the vmapped JAX
    derivation, and so do the draws made from the batch: results do not
    depend on how candidates are batched."""
    rs = np.random.default_rng(0)
    qr, qf, tr, tm = (rs.integers(0, hi, 9) for hi in (6, 1024, 6, 1024))
    base = jrng.base_key(5)
    kj = jax.vmap(lambda a, b, c, d: jrng.derive(
        base, a, b, c, d, jrng.Stream.RANSAC_MONO))(qr, qf, tr, tm)
    kt = trng.derive(trng.base_key(5), *(torch.tensor(x) for x in
                                         (qr, qf, tr, tm)),
                     trng.Stream.RANSAC_MONO)
    np.testing.assert_array_equal(_jax_words(kj), kt.numpy())
    uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (32, 8)))(kj))
    np.testing.assert_array_equal(uj, trng.uniform(kt, (32, 8)).numpy())
    # one key alone gives the same row as inside the batch
    np.testing.assert_array_equal(
        trng.uniform(kt[4], (32, 8)).numpy(), uj[4])
