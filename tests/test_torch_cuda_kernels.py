"""The nine CUDA kernels of the port against their plain PyTorch versions,
on the card, and the detection slice on the card against the CPU. These tests need an NVIDIA GPU and nvcc; elsewhere they skip.
Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Tolerance: none, except for the five-point model kernel. Matcher and
gathers are integer / copy operations; the scoring kernels are built
without FMA contraction and repeat the plain versions' operation order, so
counts are equal. The five-point kernel (K6) is built with FMA contraction
and held to its plain version by a stated contract on clean minimal
samples: before the polish every hypothesis within 3e-5 + 16 cond 2^-24,
where cond is its 5 x 9 design's condition number (the factor by which
float32's rounding of the design can move its nullspace), after it at
least 98 % of the entries within 1e-3,
and its own models solve their samples (more than 95 % of hypotheses have
a start with an epipolar residual under 5e-4); a degenerate hypothesis is
compared by its NaN/finite pattern only. Shapes
are ragged on purpose (K not a multiple of 32, H not a multiple of the
block's hypothesis tile, Kq != Kt, Kq and Kt one past the pair kernel's
tiles, more targets than one of its passes, P over one shared-memory
tile, K4 at a K too large to stage), and the scoring kernels K7, K8 and
K9 also meet residuals that sit on the threshold or one ulp beside it."""

import numpy as np
import pytest
import torch

from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import (_build, fivept, gather, hamming,
                                            score)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("Kq,Kt,all_equal", [
    (70, 99, False), (704, 704, False), (33, 1100, False),
    # one past a 64-query tile and a 176-target product; one target; every
    # target the same descriptor (ties everywhere); three passes of 704
    (65, 177, False), (70, 1, False), (130, 704, True), (200, 1500, False)])
def test_pair_top2(dev, Kq, Kt, all_equal):
    rs = np.random.default_rng(0)
    C = 5
    dt = rs.integers(0, 256, (C, Kt, 32), dtype=np.uint8)
    dt[:, 1::2] = dt[:, 0:Kt - 1:2]  # equal targets: ties
    if all_equal:
        dt[:] = dt[:, :1]
    dq = dt[:, rs.integers(0, Kt, Kq)].copy()
    dq[:, :, 3] ^= 5
    vt = rs.uniform(size=(C, Kt)) < 0.7
    vt[0] = False
    vt[1] = False
    vt[1, Kt - 1] = True
    args = [torch.from_numpy(x).to(dev) for x in (dq, dt, vt)]
    n0 = _build.launches["pair_top2"]
    got = hamming._pair_top2(*args)
    torch.cuda.synchronize()
    assert _build.launches["pair_top2"] == n0 + 1
    for g, r in zip(got, hamming._pair_top2_ref(*args)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("k,K,H,D", [
    (3, 75, 500, 3), (8, 704, 37, 3), (1, 704, 500, 3), (5, 704, 500, 3),
    (3, 704, 1030, 3), (5, 20000, 37, 3), (8, 20000, 500, 3),
    (5, 704, 37, 1), (3, 1101, 500, 6), (12, 704, 600, 3)])
def test_gathers(dev, k, K, H, D):
    """K4 with H off its hypothesis tile (37, 500, 600, 1030), k = 1 - 8 and
    12 (two passes), K too large to stage (20,000: read through the
    cache), D = 1, 3 and 6, `picks` and `order` holding entries -4, K and
    K + 100 (clamped, not read outside the candidate); K5 beside it."""
    rs = np.random.default_rng(1)
    C = 4
    data = torch.from_numpy(rs.normal(size=(C, D, K)).astype(np.float32))
    picks = torch.from_numpy(rs.integers(0, K, (C, H, k)).astype(np.int32))
    order = torch.from_numpy(np.stack(
        [rs.permutation(K) for _ in range(C)]).astype(np.int32))
    inv = torch.argsort(order, dim=1).to(torch.int32)
    oob = torch.tensor([-4, K, K + 100], dtype=torch.int32)
    picks[0, :3, 0], picks[C - 1, H - 1, k - 1] = oob, K
    order[1, :3], order[C - 1, K - 1] = oob, -4
    data, picks, order, inv = (x.to(dev) for x in (data, picks, order, inv))
    n0 = _build.launches["sample_gather_perm_t"]
    got = gather.sample_gather_perm_t(data, picks, order, inv)
    assert _build.launches["sample_gather_perm_t"] == n0 + 1
    assert torch.equal(got, gather.sample_gather_perm_t_ref(data, picks,
                                                            order))
    idx = torch.from_numpy(rs.integers(0, K, (C, K + 5)).astype(np.int32))
    idx[0, :3] = oob  # clamped, not read outside
    idx = idx.to(dev)
    assert torch.equal(gather.permute_cols(data, idx),
                       gather.permute_cols_ref(data, idx))
    with pytest.raises(TypeError):
        gather.permute_cols(data, idx.long())


@pytest.mark.parametrize("K,H", [(75, 37), (704, 500), (1100, 33)])
def test_counts(dev, K, H):
    rs = np.random.default_rng(2)
    C = 4
    p = rs.uniform(-4, 4, (C, 3, K)).astype(np.float32)
    q = rs.uniform(-4, 4, (C, 3, K)).astype(np.float32)
    valid = rs.uniform(size=(C, K)) < 0.8
    R = _so3_exp_np(rs.normal(0, 0.6, (C, H, 3))).astype(np.float32)
    t = rs.uniform(-1, 1, (C, H, 3)).astype(np.float32)
    E = rs.normal(size=(C, H, 3, 3)).astype(np.float32)
    f1 = p / np.linalg.norm(p, axis=1, keepdims=True)
    f2 = q / np.linalg.norm(q, axis=1, keepdims=True)
    R, t, E, p, q, f1, f2, valid = (torch.from_numpy(x).to(dev) for x in
                                    (R, t, E, p, q, f1, f2, valid))
    # thresholds in the thick of the residual distribution, so thousands
    # of residuals sit near them
    assert torch.equal(score.rigid_counts(R, t, p, q, valid, 6.0),
                       score.rigid_counts_ref(R, t, p, q, valid, 6.0))
    assert torch.equal(score.essential_counts(E, f1, f2, valid, 0.05),
                       score.essential_counts_ref(E, f1, f2, valid, 0.05))
    with pytest.raises(ValueError):
        score.rigid_counts(R.transpose(-1, -2), t, p, q, valid, 6.0)


@pytest.mark.parametrize("k,K,H,C,D", [
    (5, 75, 500, 4, 3), (1, 704, 64, 4, 3), (1, 704, 64, 1024, 3)] + [
    (k, 2500, H, 5, 3) for H in (1, 33, 100, 513) for k in (1, 3, 8, 9)] + [
    (1, 2500, 64, 5, 1), (1, 2500, 100, 5, 6), (3, 2500, 33, 5, 6),
    (9, 2500, 33, 5, 1)])
def test_sample_gather_t(dev, k, K, H, C, D):
    """K3 at the verification path's shape (k = 1, H = 64, K = 704, C =
    1024, D = 3), H off the block's 256 pairs and not a divisor of it, k
    over one pass of 8 sample points (9: two), D of 1 and 6 (k = 1 there
    takes the staged kernel), picks -2 and K + 9 (clamped)."""
    rs = np.random.default_rng(3)
    data = torch.from_numpy(rs.normal(size=(C, D, K)).astype(np.float32))
    picks = torch.from_numpy(rs.integers(0, K, (C, H, k)).astype(np.int32))
    picks[0, 0, 0], picks[1, min(3, H - 1), k - 1] = -2, K + 9  # clamped
    data, picks = data.to(dev), picks.to(dev)
    n0 = _build.launches["sample_gather_t"]
    got = gather.sample_gather_t(data, picks)
    assert _build.launches["sample_gather_t"] == n0 + 1
    assert torch.equal(got, gather.sample_gather_t_ref(data, picks))


def _fivept_samples(rs, C, H):
    P = rs.uniform(-3, 3, (C, H, 5, 3))
    P[..., 2] = rs.uniform(3, 9, (C, H, 5))
    R = _so3_exp_np(rs.normal(0, 0.3, (C, 3))).astype(np.float64)
    P2 = np.einsum("chkj,cji->chki", P - 0.3, R)
    f = [X / np.linalg.norm(X, axis=-1, keepdims=True) for X in (P, P2)]
    return [torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 3, 1).reshape(C, 15, H).astype(np.float32)))
        for x in f]


def _design_cond(f1, f2):
    """(C, H) condition number of each hypothesis's 5 x 9 design."""
    C, _, H = f1.shape
    a = f1.double().reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    b = f2.double().reshape(C, 5, 3, H).permute(0, 3, 1, 2)
    sv = torch.linalg.svdvals(torch.einsum("nhkr,nhkq->nhkrq", b, a)
                              .reshape(C, H, 5, 9))
    return sv[..., 0] / sv[..., 4]


@pytest.mark.parametrize("H,gn_iters", [(37, 0), (500, 8), (130, 3)])
def test_fivept_models(dev, H, gn_iters):
    rs = np.random.default_rng(4)
    f1, f2 = (x.to(dev) for x in _fivept_samples(rs, 3, H))
    # a degenerate hypothesis: all five samples the same bearing pair
    f1[1, :, 0] = f1[1, 0:3, 0].repeat(5)
    f2[1, :, 0] = f2[1, 0:3, 0].repeat(5)
    n0 = _build.launches["fivept_models"]
    got = fivept.fivept_models(f1, f2, n_starts=8, gn_iters=gn_iters,
                               project=False)
    assert _build.launches["fivept_models"] == n0 + 1
    ref = fivept._fivept_models_ref(f1, f2, 8, gn_iters, project=False)
    assert got.shape == (3, 72, H)
    # the degenerate hypothesis: NaN/finite pattern only
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    clean = torch.ones(3, 72, H, dtype=torch.bool, device=dev)
    clean[1, :, 0] = False
    diff = (got - ref).abs()
    if gn_iters == 0:
        limit = 3e-5 + 16 * _design_cond(f1, f2) * 2.0 ** -24
        err = torch.where(clean & torch.isfinite(diff), diff,
                          torch.zeros_like(diff)).amax(1)
        over = err > limit
        assert not over.any(), (err[over], limit[over])
    else:
        share = float((diff[clean] <= 1e-3).float().mean())
        assert share >= 0.98, share
    if gn_iters == 8:
        E = fivept.models_to_flat(got, 8).reshape(3, H, 8, 3, 3)
        a = f1.reshape(3, 5, 3, H).permute(0, 3, 1, 2)
        b = f2.reshape(3, 5, 3, H).permute(0, 3, 1, 2)
        resid = torch.einsum("chkj,chsji,chki->chsk", b, E, a).abs()
        best = resid.amax(-1).amin(-1)[clean[:, 0]]
        solved = float((best < 5e-4).float().mean())
        assert solved > 0.95, solved


@pytest.mark.parametrize("H,S,P", [(500, 8, 64), (45, 3, 300)])
def test_presel_counts(dev, H, S, P):
    rs = np.random.default_rng(5)
    C = 3
    E_rows = rs.normal(size=(C, 9 * S, H)).astype(np.float32)
    f1 = rs.normal(size=(C, 3, P)).astype(np.float32)
    f2 = rs.normal(size=(C, 3, P)).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=1, keepdims=True)
    valid = rs.uniform(size=(C, P)) < 0.8
    valid[0] = False
    args = [torch.from_numpy(x).to(dev) for x in (E_rows, f1, f2, valid)]
    n0 = _build.launches["presel_counts"]
    got = fivept.presel_counts(*args, 0.05, S)
    assert _build.launches["presel_counts"] == n0 + 1
    assert got.shape == (C, H, S) and got.dtype == torch.int32
    assert torch.equal(got, fivept.presel_counts_ref(*args, 0.05, S))
    assert int(got.sum()) > 0


# Boundary inputs of K8, K7 and K9: residuals placed on the threshold, or one
# ulp beside it, in the plain versions' float32 operations (numpy float32
# replays them), by walking one or two inputs of a designated residual
# over a grid of ulps; a residual whose walk lands on no target keeps its
# nearest value. Some models hold NaN, +-inf or zeros; candidate 4 has no
# valid point, candidate 5 one.


def _rows32(M, x):
    return [(M[..., i, 0] * x[..., 0] + M[..., i, 1] * x[..., 1])
            + M[..., i, 2] * x[..., 2] for i in range(3)]


def _walk(x, steps):
    bits = (x.view(np.int32)[..., None]
            + np.sign(x).astype(np.int32)[..., None] * steps)
    return bits.astype(np.int32).view(np.float32)


def _land(vals, target, xs):
    """Move each x of `xs` ((x, steps) pairs, the grid axes of `vals` in
    order) to the first grid point whose value equals `target`."""
    hit = vals.reshape(*target.shape, -1) == target[..., None]
    j, ok = hit.argmax(-1), hit.any(-1)
    out = []
    for x, st in reversed(xs):
        j, k = np.divmod(j, len(st))
        moved = np.take_along_axis(_walk(x, st), k[..., None], -1)[..., 0]
        out.append(np.where(ok, moved, x))
    return out[::-1]


def _near(x, t):
    t = np.float32(t)
    return ((x >= np.nextafter(t, np.float32(0)))
            & (x <= np.nextafter(t, np.float32(np.inf))))


def _sampson32(E, a, b):
    ef, et = _rows32(E, a), _rows32(np.swapaxes(E, -1, -2), b)
    num = (b[..., 0] * ef[0] + b[..., 1] * ef[1]) + b[..., 2] * ef[2]
    den = ((ef[0] * ef[0] + ef[1] * ef[1]) + et[0] * et[0]) + et[1] * et[1]
    return (num * num) / np.maximum(den, np.float32(1e-12))


def _valid(rs, C, K, share):
    v = rs.uniform(size=(C, K)) < share
    v[C - 2] = False
    v[C - 1] = False
    v[C - 1, 4] = True
    return v


def _rigid_boundary(rs, C, H, K, thr, share):
    T = np.float32(thr * thr)
    tg = np.array([np.nextafter(T, np.float32(0)), T,
                   np.nextafter(T, np.float32(np.inf))])[np.arange(K) % 3]
    s = np.sqrt(float(T))
    R = _so3_exp_np(rs.normal(0, 0.6, (C, H, 3)))
    t = rs.uniform(-s / 2, s / 2, (C, H, 3)).astype(np.float32)
    p = rs.uniform(-s, s, (C, 3, K)).astype(np.float32)
    h = np.arange(K) % H
    w = _rows32(R[:, h], np.moveaxis(p, 1, -1))
    w = [w[i] + t[:, h, i] for i in range(3)]
    u = rs.normal(size=(C, K, 3))
    u = (s * u / np.linalg.norm(u, axis=-1, keepdims=True)).astype(np.float32)
    q = np.stack([w[i] + u[..., i] for i in range(3)], 1)
    st = np.arange(-12, 13)
    r0 = _walk(q[:, 0], st)[..., :, None] - w[0][..., None, None]
    r1 = _walk(q[:, 1], st)[..., None, :] - w[1][..., None, None]
    r2 = (q[:, 2] - w[2])[..., None, None]
    q[:, 0], q[:, 1] = _land((r0 * r0 + r1 * r1) + r2 * r2,
                             np.broadcast_to(tg, (C, K)),
                             [(q[:, 0], st), (q[:, 1], st)])
    R[:, H - 1, 0, 0] = np.nan
    R[:, H - 2, 1, 2] = np.inf
    R[:, H - 3, 2, 1] = -np.inf
    t[:, H - 4, 0] = np.inf
    R[:, H - 5], t[:, H - 5] = 0, 0
    valid = _valid(rs, C, K, share)
    w = _rows32(R[:, :, None], np.moveaxis(p, 1, -1)[:, None])
    r = [q[:, None, i] - (w[i] + t[:, :, None, i]) for i in range(3)]
    d2 = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]
    return (R, t, p, np.ascontiguousarray(q), valid), int(
        (_near(d2, T) & valid[:, None]).sum())


# ulps from the threshold at which the Sampson boundary residuals sit: half
# within one ulp, the rest across the band where the rule of K7 and K9
# divides (4 - 16 ulps) and just outside it
_OFFSETS = np.array([-1, 0, 1, -1, 0, 1, -4, 4, -8, 8, -12, 12, -16, 16])


def _bearings_on_threshold(rs, Em, a, thr):
    """f2 bearings b (C, P, 3) with the squared Sampson error of model
    Em[:, p] at (a_p, b_p) _OFFSETS[p % 14] ulps from float32(thr). The
    first two rows of each model are orthogonal to its a, so
    num = f2 . (E f1) is mostly b2 (E f1)_2 and moves by about an ulp per
    ulp of b2: b2 comes from bisection in float64, then b0 and b2 are
    walked over a grid of ulps."""
    C, P = a.shape[:2]
    t32 = np.float32(thr)
    tg = _walk(np.array([t32]), _OFFSETS)[0][np.arange(P) % len(_OFFSETS)]
    ef = np.stack(_rows32(Em, a), -1).astype(np.float64)
    c2 = rs.normal(size=(C, P, 2))
    c2 /= np.linalg.norm(c2, axis=-1, keepdims=True)

    def bearing(b2):
        r = np.sqrt(1 - b2 * b2)
        return np.stack([c2[..., 0] * r, c2[..., 1] * r, b2], -1)

    lo, hi = np.zeros((C, P)), np.ones((C, P))
    for _ in range(60):
        mid = (lo + hi) / 2
        b = bearing(mid)
        et = np.einsum("cpji,cpj->cpi", Em.astype(np.float64), b)
        num = np.sum(b * ef, -1)
        neg = num * num < float(t32) * (ef[..., 0] ** 2 + ef[..., 1] ** 2
                                        + et[..., 0] ** 2 + et[..., 1] ** 2)
        lo, hi = np.where(neg, mid, lo), np.where(neg, hi, mid)
    b = bearing(lo).astype(np.float32)
    s0, s2 = np.arange(-4, 5), np.arange(-32, 33)
    grid = np.stack(np.broadcast_arrays(
        _walk(b[..., 0], s0)[..., :, None], b[..., 1, None, None],
        _walk(b[..., 2], s2)[..., None, :]), -1)
    b[..., 0], b[..., 2] = _land(
        _sampson32(Em[:, :, None, None], a[:, :, None, None], grid),
        np.broadcast_to(tg, (C, P)), [(b[..., 0], s0), (b[..., 2], s2)])
    return b


def _presel_boundary(rs, C, H, S, P, thr, share):
    a = rs.normal(size=(C, P, 3))
    a = (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
    a64 = a.astype(np.float64)
    E = rs.normal(size=(C, H * S, 3, 3))   # model p scores point p
    Em = E[:, :P]
    for i in (0, 1):
        Em[..., i, :] -= np.sum(Em[..., i, :] * a64, -1, keepdims=True) * a64
    Em[..., 2, :] = a64 + 0.3 * Em[..., 2, :]
    E = E.astype(np.float32)
    b = _bearings_on_threshold(rs, E[:, :P], a, thr)
    E[:, (H - 1) * S:] = np.nan
    E[:, (H - 2) * S, 0, 0] = np.inf
    E[:, (H - 2) * S + 1, 1, 2] = -np.inf
    E[:, (H - 2) * S + 2] = np.inf
    E[:, (H - 3) * S:(H - 2) * S] = 0
    valid = _valid(rs, C, P, share)
    err = _sampson32(E[:, :, None], a[:, None], b[:, None])
    rows = E.reshape(C, H, S, 9).transpose(0, 3, 2, 1).reshape(C, 9 * S, H)
    return (np.ascontiguousarray(rows), np.ascontiguousarray(
        np.moveaxis(a, -1, 1)), np.ascontiguousarray(np.moveaxis(b, -1, 1)),
        valid), int((_near(err, np.float32(thr)) & valid[:, None]).sum())


def _essential_boundary(rs, C, H, K, thr, share):
    """K9's inputs (E (C, H, 3, 3), f1, f2 (C, 3, K), valid): model k % H
    scores point k on the threshold (`_bearings_on_threshold`), its f1 the
    unit normal of the model's first two rows, of random sign. NaN, inf and
    zero models; every model of candidate C - 2 (no valid point) is NaN, as
    `ransac_essential` passes them."""
    E = rs.normal(size=(C, H, 3, 3))
    n = np.cross(E[..., 0, :], E[..., 1, :])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    E[..., 2, :] = n + 0.3 * E[..., 2, :]
    E = E.astype(np.float32)
    h = np.arange(K) % H
    sign = np.where(rs.uniform(size=(C, K, 1)) < 0.5, -1.0, 1.0)
    a = (sign * n[:, h]).astype(np.float32)
    b = _bearings_on_threshold(rs, E[:, h], a, thr)
    E[:, H - 1] = np.nan
    E[:, H - 2, 0, 0] = np.inf
    E[:, H - 3, 1, 2] = -np.inf
    E[:, H - 4] = np.inf
    E[:, H - 5] = 0
    E[C - 2] = np.nan
    valid = _valid(rs, C, K, share)
    err = _sampson32(E[:, :, None], a[:, None], b[:, None])
    return (E, np.ascontiguousarray(np.moveaxis(a, -1, 1)),
            np.ascontiguousarray(np.moveaxis(b, -1, 1)), valid), int(
        (_near(err, np.float32(thr)) & valid[:, None]).sum())


@pytest.mark.parametrize("share", [1.0, 0.6])
@pytest.mark.parametrize("thr", [0.3, 0.25])
def test_counts_boundary(dev, thr, share):
    """K8 at residuals on the threshold (thr^2 = 0.09 and 2^-4), K = 1100,
    every point valid or 60 % scattered: counts equal."""
    rs = np.random.default_rng(6)
    inputs, near = _rigid_boundary(rs, 6, 45, 1100, thr, share)
    assert near >= 100
    args = [torch.from_numpy(x).to(dev) for x in inputs]
    n0 = _build.launches["rigid_counts"]
    got = score.rigid_counts(*args, thr)
    assert _build.launches["rigid_counts"] == n0 + 1
    assert torch.equal(got, score.rigid_counts_ref(*args, thr))


@pytest.mark.parametrize("share", [1.0, 0.6])
@pytest.mark.parametrize("thr", [1e-6, 0.05, 0.0625])
def test_presel_counts_boundary(dev, thr, share):
    """K7 at Sampson errors on the threshold and across the band where its
    rule divides, P = 300 (two tiles), every point valid or 60 %
    scattered, NaN / inf / zero models: counts equal."""
    rs = np.random.default_rng(7)
    inputs, near = _presel_boundary(rs, 6, 45, 8, 300, thr, share)
    assert near >= 100
    args = [torch.from_numpy(x).to(dev) for x in inputs]
    n0 = _build.launches["presel_counts"]
    got = fivept.presel_counts(*args, thr, 8)
    assert _build.launches["presel_counts"] == n0 + 1
    assert torch.equal(got, fivept.presel_counts_ref(*args, thr, 8))


@pytest.mark.parametrize("thr", [3.0, 1e-30])
def test_presel_counts_outside_rule(dev, thr):
    """Thresholds outside 2^-60 .. 1, where K7 divides for every residual
    (the launcher's other instantiation): counts equal."""
    rs = np.random.default_rng(8)
    C, H, S, P = 3, 45, 4, 300
    E_rows = rs.normal(size=(C, 9 * S, H)).astype(np.float32)
    f1, f2 = rs.normal(size=(2, C, 3, P)).astype(np.float32)
    E_rows[1, :9 * S:S, 0] = 0       # an all-zero model: err is 0 / 1e-12
    valid = rs.uniform(size=(C, P)) < 0.6
    args = [torch.from_numpy(x).to(dev) for x in (E_rows, f1, f2, valid)]
    got = fivept.presel_counts(*args, thr, S)
    assert torch.equal(got, fivept.presel_counts_ref(*args, thr, S))


@pytest.mark.parametrize("share", [1.0, 0.6])
@pytest.mark.parametrize("thr", [1e-6, 0.05, 0.0625])
def test_essential_counts_boundary(dev, thr, share):
    """K9 at Sampson errors on the threshold and across the band where its
    rule divides, K = 1101 (two staging tiles), every point valid or 60 %
    scattered, NaN / inf / zero models: counts equal."""
    rs = np.random.default_rng(9)
    inputs, near = _essential_boundary(rs, 6, 45, 1101, thr, share)
    assert near >= 100
    args = [torch.from_numpy(x).to(dev) for x in inputs]
    n0 = _build.launches["essential_counts"]
    got = score.essential_counts(*args, thr)
    assert _build.launches["essential_counts"] == n0 + 1
    assert torch.equal(got, score.essential_counts_ref(*args, thr))


@pytest.mark.parametrize("thr", [3.0, 1e-30])
def test_essential_counts_outside_rule(dev, thr):
    """Thresholds outside 2^-60 .. 1, where K9 divides for every residual
    (the launcher's other instantiation): counts equal."""
    rs = np.random.default_rng(10)
    C, H, K = 3, 300, 1101
    E = rs.normal(size=(C, H, 3, 3)).astype(np.float32)
    f1, f2 = rs.normal(size=(2, C, 3, K)).astype(np.float32)
    E[1, 0] = 0                      # an all-zero model: err is 0 / 1e-12
    E[2, 1] = np.nan
    valid = rs.uniform(size=(C, K)) < 0.6
    args = [torch.from_numpy(x).to(dev) for x in (E, f1, f2, valid)]
    got = score.essential_counts(*args, thr)
    assert torch.equal(got, score.essential_counts_ref(*args, thr))


def _bits(x, dev):
    from kimera_multi_tpu_torch.kernels.hamming import unpack_bits

    return unpack_bits(torch.from_numpy(x)).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("Kq", [1, 63, 200, 704, 705, 1500])
@pytest.mark.parametrize("Kt,n_splits,case", [
    (1, None, "dup"), (2, None, "dup"), (175, None, "dup"),
    (176, None, "dup"), (177, None, "dup"), (351, 2, "dup"),
    (352, 2, "dup"), (353, 2, "dup"), (1000, 3, "dup"), (4096, 16, "dup"),
    (4096, 2, "dup"), (531, None, "equal")])
def test_hamming_top2(dev, Kq, Kt, n_splits, case):
    """K2 equal to its plain version: Kq one tile, one row short of a tile,
    ragged, a whole block of 704 queries, and past it (705: a second block
    of one row; 1500: a third, ragged block of two tiles); Kt of one and
    two rows (d2 = 1e9 for one), at and around the 176-row chunk and a
    split's size; duplicated rows (ties everywhere), an exact copy of the
    first query on both sides of a chunk boundary and of the last query
    (in the last block) on both sides of a split boundary (the earlier
    index wins, d2 == d1), and a database of one row repeated."""
    rs = np.random.default_rng(Kq + Kt)
    t = rs.integers(0, 256, (Kt, 32), dtype=np.uint8)
    if case == "equal":
        t[:] = t[0]
    else:
        t[1::2] = t[0:Kt - 1:2]
    q = t[rs.integers(0, Kt, Kq)].copy()
    q[:, 7] ^= rs.integers(1, 256, Kq, dtype=np.uint8)  # no exact copy
    rows = hamming.top2_split_rows(Kq, Kt, n_splits, dev)
    cuts = []  # boundaries to place a tie on: a chunk's, a split's
    if case == "dup" and hamming._TOP2_TILE < min(rows, Kt - 1):
        cuts.append(hamming._TOP2_TILE)
    if case == "dup" and rows < Kt:
        cuts.append(rows)
    # query -> first index of its copies
    ties = dict(zip(sorted({0, Kq - 1}), cuts))
    for qi, cut in ties.items():
        t[cut - 1] = t[cut] = q[qi]
        ties[qi] = cut - 1
    bq, bt = _bits(q, dev), _bits(t, dev)
    n0 = _build.launches["hamming_top2"]
    got = hamming._hamming_top2(bq, bt, n_splits)
    torch.cuda.synchronize()
    assert _build.launches["hamming_top2"] == n0 + 1
    ref = hamming._hamming_top2_ref(bq, bt)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if Kt == 1:
        assert bool((got[1] == hamming._TOP2_NONE).all())
    for qi, r in ties.items():
        assert int(got[2][qi]) == r and float(got[0][qi]) == 0.0
        assert float(got[1][qi]) == 0.0
    # the public wrapper takes the same kernel
    for g, r in zip(hamming.hamming_top2_pallas(bq, bt, 1, 1), ref):
        assert torch.equal(g, r)


def test_detection_cuda_equals_cpu(dev):
    """BoW vectors and detections of the front-end on the card equal those
    on the CPU (no CUDA-only tie order or atomics order)."""
    from kimera_multi_tpu_torch.frontend import batched, dlc, vocab
    from kimera_multi_tpu_torch.io import sim_world

    w = sim_world.make_world(n_robots=3, n_steps=60, features_per_kf=96,
                             seed=3)
    corpus = w.descriptors[w.obs_valid].reshape(-1, 32)
    voc = vocab.build_vocabulary(corpus[:: max(1, len(corpus) // 4000)],
                                 k=8, depth=3, seed=3)
    cfg = dlc.FrontendConfig()
    outs = []
    for d in ("cpu", dev):
        fe = batched.BatchedFrontend(3, 60, voc, cfg, n_candidates=3,
                                     device=d)
        ids, wts, _, _, ovf = fe.compute_bows(w.descriptors, w.obs_valid)
        det, _ = fe._detect(*fe._bow_all(
            torch.from_numpy(w.descriptors).to(d),
            torch.from_numpy(w.obs_valid).to(d))[:4],
            w.obs_valid.any(-1))
        outs.append((ids, wts, ovf, [x.cpu() for x in det]))
    (i0, w0, o0, d0), (i1, w1, o1, d1) = outs
    assert np.array_equal(i0, i1) and o0 == o1
    np.testing.assert_allclose(w1, w0, rtol=1e-6, atol=0)
    assert torch.equal(d0[0], d1[0]) and torch.equal(d0[2], d1[2])
    assert int(d0[2].sum()) > 0
    np.testing.assert_allclose(d1[1].numpy(), d0[1].numpy(), rtol=1e-6)
