"""The port's descriptor matcher against the JAX package's, on shared numpy
inputs: the vmapped XLA path (`knn2_lowe_match`) and the Pallas pair kernel
run in interpret mode. On the CPU the port takes the plain version of its
CUDA kernel. Tolerance: none — match indices and distances are integers
and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.kernels import hamming as jh
from kimera_multi_tpu_torch.kernels import hamming as th


def _pairs(case, C=3, Kq=70, Kt=96, seed=0):
    """Descriptor pairs with true matches (3 flipped bits), clutter, and
    the validity pattern named by `case`. Kq != Kt, neither a multiple of
    128."""
    rs = np.random.default_rng(seed)
    dt = rs.integers(0, 256, (C, Kt, 32), dtype=np.uint8)
    src = rs.integers(0, Kt, (C, Kq))
    dq = np.take_along_axis(dt, src[:, :, None], axis=1).copy()
    dq[np.arange(C)[:, None], np.arange(Kq)[None, :],
       rs.integers(0, 32, (C, Kq))] ^= 7
    clutter = rs.uniform(size=(C, Kq)) < 0.3
    dq[clutter] = rs.integers(0, 256, (int(clutter.sum()), 32), dtype=np.uint8)
    vq = np.ones((C, Kq), bool)
    vt = np.ones((C, Kt), bool)
    if case == "masked":
        vq = rs.uniform(size=(C, Kq)) < 0.8
        vt = rs.uniform(size=(C, Kt)) < 0.7
    elif case == "zero_one_valid":
        vt[0] = False                      # no valid target at all
        vt[1] = False
        vt[1, 17] = True                   # exactly one valid target
        vt[2] = False
        vt[2, [3, 90]] = True              # exactly two
    elif case == "ties":
        dt[:, 1::2] = dt[:, 0::2]          # duplicate targets: d1 == d2 ties
        dq = np.take_along_axis(dt, src[:, :, None], axis=1).copy()
    return dq, vq, dt, vt


CASES = ["all_valid", "masked", "zero_one_valid", "ties"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", ["xla", "interpret"])
def test_knn2_lowe_match_pairs(case, path):
    dq, vq, dt, vt = _pairs(case)
    mj, dj = jh.knn2_lowe_match_pairs(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt),
        lowe_ratio=0.7, interpret=(path == "interpret"))
    mt, d1t = th.knn2_lowe_match_pairs(
        torch.from_numpy(dq), torch.from_numpy(vq), torch.from_numpy(dt),
        torch.from_numpy(vt), lowe_ratio=0.7)
    assert mt.dtype == torch.int32 and d1t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), d1t.numpy())
    if case == "all_valid":
        assert (mt >= 0).sum() > 0.4 * mt.numel()   # matches do occur
    if case == "zero_one_valid":
        assert (mt[0] == -1).all() and (d1t[0] == 512).all()
        assert set(mt[1].tolist()) <= {-1, 17}


@pytest.mark.parametrize("max_distance", [256, 2])
def test_max_distance_and_ratio(max_distance):
    dq, vq, dt, vt = _pairs("all_valid", seed=3)
    mj, dj = jh.knn2_lowe_match_pairs(
        jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt), jnp.asarray(vt),
        lowe_ratio=0.85, max_distance=max_distance)
    mt, d1t = th.knn2_lowe_match_pairs(
        torch.from_numpy(dq), torch.from_numpy(vq), torch.from_numpy(dt),
        torch.from_numpy(vt), lowe_ratio=0.85, max_distance=max_distance)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), d1t.numpy())


def test_unpack_bits_and_hamming_matrix():
    rs = np.random.default_rng(1)
    a = rs.integers(0, 256, (37, 32), dtype=np.uint8)
    b = rs.integers(0, 256, (50, 32), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(jh.unpack_bits(jnp.asarray(a))),
        th.unpack_bits(torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(
        np.unpackbits(a, axis=-1, bitorder="little"),
        th.unpack_bits(torch.from_numpy(a)).numpy())
    D = th.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b))),
        D.numpy())
    popc = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(popc, D.numpy())


def test_pair_top2_ref_first_index_on_ties():
    """The plain version the CUDA kernel is held against: lowest index
    wins among equal distances, 512 stands for no valid target."""
    dq, vq, dt, vt = _pairs("ties", seed=5)
    d1, d2, i1 = th._pair_top2_ref(torch.from_numpy(dq), torch.from_numpy(dt),
                                   torch.from_numpy(vt))
    D = np.unpackbits(dq[:, :, None, :] ^ dt[:, None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(i1.numpy(), D.argmin(-1))
    np.testing.assert_array_equal(d1.numpy(), D.min(-1))
    np.testing.assert_array_equal(d2.numpy(), np.sort(D, -1)[..., 1])
    none = torch.zeros_like(torch.from_numpy(vt))
    d1, d2, i1 = th._pair_top2_ref(torch.from_numpy(dq), torch.from_numpy(dt),
                                   none)
    assert (d1 == 512).all() and (d2 == 512).all() and (i1 == 0).all()


def _top2_bits(Kq=128, Kt=512, seed=6):
    """Query and database bit rows with exact ties: every target row is
    repeated once (rows 2i and 2i+1), queries are noisy copies of
    targets."""
    rs = np.random.default_rng(seed)
    t = rs.integers(0, 256, (Kt, 32), dtype=np.uint8)
    t[1::2] = t[0::2]
    q = t[rs.integers(0, Kt, Kq)].copy()
    q[:, 4] ^= rs.integers(0, 256, Kq, dtype=np.uint8)
    q[: Kq // 4] = rs.integers(0, 256, (Kq // 4, 32), dtype=np.uint8)
    return q, t


def test_hamming_top2_ref_matches_pallas():
    """K2's plain version against the JAX Pallas kernel (interpret mode on
    the CPU, as tests/test_kernels_match_ransac.py runs it) and the
    first-min argmin of the distance matrix. Exact: distances are
    integers."""
    q, t = _top2_bits()
    jq = jh.unpack_bits(jnp.asarray(q)).astype(jnp.bfloat16)
    jt = jh.unpack_bits(jnp.asarray(t)).astype(jnp.bfloat16)
    jd1, jd2, ji1 = (np.asarray(x) for x in jh.hamming_top2_pallas(
        jq, jt, tile_q=64, tile_t=256))
    tq = th.unpack_bits(torch.from_numpy(q)).to(torch.bfloat16)
    tt = th.unpack_bits(torch.from_numpy(t)).to(torch.bfloat16)
    d1, d2, i1 = th.hamming_top2_pallas(tq, tt, tile_q=64, tile_t=256)
    assert (d1.dtype, d2.dtype, i1.dtype) == (torch.float32, torch.float32,
                                              torch.int32)
    D = np.asarray(jh.hamming_matrix(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_array_equal(d1.numpy(), jd1)
    np.testing.assert_array_equal(d2.numpy(), jd2)
    np.testing.assert_array_equal(d1.numpy(), D.min(1))
    np.testing.assert_array_equal(d2.numpy(), np.sort(D, axis=1)[:, 1])
    np.testing.assert_array_equal(i1.numpy(), D.argmin(1))  # first minimum
    np.testing.assert_array_equal(ji1, D.argmin(1))
    # every duplicated target makes a tie: d2 == d1 for copied queries
    assert (d2.numpy() == d1.numpy()).sum() >= 96


def test_hamming_top2_chunks_and_shapes():
    """The plain version merges target chunks in order: chunk boundaries
    that cut through a tie keep the first index. Shapes that are not
    multiples of the tiles raise."""
    q, t = _top2_bits(Kq=64, Kt=300, seed=7)
    t[150] = q[3]   # a tie of distance 0 across the boundary at 151
    t[151] = q[3]
    tq = th.unpack_bits(torch.from_numpy(q)).to(torch.bfloat16)
    tt = th.unpack_bits(torch.from_numpy(t)).to(torch.bfloat16)
    whole = th._hamming_top2_ref(tq, tt, chunk=300)
    for chunk in (151, 64, 1):
        for a, b in zip(whole, th._hamming_top2_ref(tq, tt, chunk=chunk)):
            assert torch.equal(a, b)
    assert int(whole[2][3]) == 150 and float(whole[1][3]) == 0.0
    with pytest.raises(ValueError):
        th.hamming_top2_pallas(tq, tt, tile_q=64, tile_t=256)
    with pytest.raises(ValueError):
        th.hamming_top2_pallas(tq[:63], tt, tile_q=64, tile_t=300)


def test_pair_top2_refuses_more_targets_than_its_keys_hold():
    """The pair kernel's keys carry the target column in 21 bits: the
    wrapper raises before it looks at the device (no memory is needed for
    an expanded view)."""
    Kt = th._PAIR_MAX_KT + 1
    dq = torch.zeros(1, 4, 32, dtype=torch.uint8)
    dt = torch.zeros(1, 1, 32, dtype=torch.uint8).expand(1, Kt, 32)
    vt = torch.ones(1, 1, dtype=torch.bool).expand(1, Kt)
    with pytest.raises(ValueError, match="targets"):
        th._pair_top2(dq, dt, vt)


@pytest.mark.parametrize("Kt", [1, 175, 177, 4_325_376, (1 << 22) + 1,
                                3 << 22])
def test_top2_splits_fit_the_keys(Kt):
    """The DB-wide kernel's keys carry a target's column within its split
    in 22 bits. A caller's n_splits gives splits of whole 176-row chunks
    that cover the targets with none empty and never more rows than the
    keys hold; where it would give more, it raises."""
    for n_splits in (1, 2, 3, 7, 132, 70000):
        n = min(n_splits, 65535)
        try:
            rows = th.top2_split_rows(704, Kt, n_splits)
        except ValueError as e:
            assert "keys hold" in str(e)
            assert Kt > n * (th._TOP2_MAX_SPLIT - th._TOP2_TILE)
            continue
        S = -(-Kt // rows)
        assert rows % th._TOP2_TILE == 0 and rows <= th._TOP2_MAX_SPLIT
        assert (S - 1) * rows < Kt <= S * rows and S <= n
    if Kt > th._TOP2_MAX_SPLIT:
        with pytest.raises(ValueError, match="keys hold"):
            th.top2_split_rows(704, Kt, 1)


def test_hamming_top2_guard_raises_without_a_card():
    """The CUDA wrapper refuses a caller's split larger than the keys hold
    before it looks at the device (an expanded view: no memory)."""
    bq = torch.zeros(4, 256, dtype=torch.bfloat16)
    bt = torch.zeros(1, 256, dtype=torch.bfloat16).expand(
        th._TOP2_MAX_SPLIT + 1, 256)
    with pytest.raises(ValueError, match="keys hold"):
        th._hamming_top2(bq, bt, n_splits=1)
