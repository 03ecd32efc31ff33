"""The port's small-matrix algebra and minimal solvers (kernels/linalg.py,
soa.py, minimal.py) against the same-named JAX functions on shared numpy
inputs, float32 on the CPU.

Tolerances: 1e-5 (rtol and atol) for closed-form chains, whose only
differences are the rounding of transcendental functions and of summation
order. The essential-matrix solvers take the bottom eigenvector of a
float32 normal matrix; a rounding difference dN in that matrix moves the
eigenvector by about dN / (lambda_2 - lambda_1), so they are compared on
well-conditioned data (bearings spread over the whole sphere, with 3e-4
rad of noise so that lambda_1 is above the solver's shift) at 1e-4, and
up to sign, since E and -E are the same model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.kernels import linalg as jl, minimal as jm, soa as jsoa
from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import (linalg as tl, minimal as tm,
                                            soa as tsoa)

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _sym(rs, n, scale=1.0):
    A = rs.normal(size=(n, 3, 3)) * scale
    return (A + A.transpose(0, 2, 1)).astype(np.float32)


def _wide_pair(C, K, seed, noise=3e-4):
    """Two views of a point cloud all around the cameras: (f1, f2, P, Pb)
    coordinate-major (C, 3, K)."""
    rs = np.random.default_rng(seed)
    P = rs.uniform(-6, 6, (C, 3, K))
    R = _so3_exp_np(rs.normal(0, 0.4, (C, 3))).astype(np.float64)
    t = rs.uniform(-1, 1, (C, 3))
    Pb = np.einsum("cji,cjk->cik", R, P - t[:, :, None])

    def bearings(X):
        f = X / np.linalg.norm(X, axis=1, keepdims=True)
        f = f + rs.normal(0, noise, f.shape)
        return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(
            np.float32)

    return bearings(P), bearings(Pb), P.astype(np.float32), \
        Pb.astype(np.float32)


def _to_lists(x, fn):
    """(n, 3, B) -> list of n vec3s of `fn`-converted (B,) components."""
    return [[fn(np.ascontiguousarray(x[m, i])) for i in range(3)]
            for m in range(x.shape[0])]


def _close_up_to_sign(a, b, tol):
    s = np.sign(np.sum(a * b, axis=(-1, -2), keepdims=True))
    np.testing.assert_allclose(a, s * b, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["generic", "repeated", "rank1", "zero"])
def test_eigh3x3(kind):
    rs = np.random.default_rng(0)
    A = _sym(rs, 16)
    if kind == "repeated":
        A = np.broadcast_to(np.diag([2.0, 2.0, 5.0]).astype(np.float32),
                            (16, 3, 3)).copy()
    elif kind == "rank1":
        v = rs.normal(size=(16, 3)).astype(np.float32)
        A = v[:, :, None] * v[:, None, :]
    elif kind == "zero":
        A = np.zeros((16, 3, 3), np.float32)
    ej, Vj = jl.eigh3x3(jnp.asarray(A))
    et, Vt = tl.eigh3x3(torch.from_numpy(A))
    assert torch.isfinite(Vt).all() and torch.isfinite(et).all()
    if kind == "generic":
        np.testing.assert_allclose(np.asarray(ej), et.numpy(), **TOL)
        np.testing.assert_allclose(np.asarray(Vj), Vt.numpy(), **TOL)
    else:
        # repeated eigenvalues: acos(r) at r = +-1 turns a 1e-7 rounding of
        # r into 3e-4 of angle, so values agree to 1e-3 of the largest and
        # the eigenvectors of the repeated value are any basis of its
        # plane; hold the decomposition itself instead
        scale = max(float(np.abs(A).max()), 1.0)
        np.testing.assert_allclose(np.asarray(ej), et.numpy(),
                                   atol=1e-3 * scale)
        rec = Vt @ torch.diag_embed(et) @ Vt.transpose(-1, -2)
        np.testing.assert_allclose(rec.numpy(), A, atol=2e-3 * scale)
        np.testing.assert_allclose(
            (Vt.transpose(-1, -2) @ Vt).numpy(),
            np.broadcast_to(np.eye(3, dtype=np.float32), A.shape), atol=1e-4)
    # the SoA form agrees with the AoS form
    As = [[torch.from_numpy(np.ascontiguousarray(A[:, i, j]))
           for j in range(3)] for i in range(3)]
    es, Vs = tsoa.eigh3x3(As)
    tol = TOL if kind == "generic" else dict(atol=1e-3 * scale)
    np.testing.assert_allclose(torch.stack(es, -1).numpy(), et.numpy(), **tol)
    if kind == "generic":
        np.testing.assert_allclose(
            torch.stack([torch.stack(v, -1) for v in Vs], -1).numpy(),
            Vt.numpy(), **TOL)


@pytest.mark.parametrize("kind", ["generic", "rank2", "rank1"])
def test_so3_procrustes(kind):
    rs = np.random.default_rng(1)
    H = rs.normal(size=(16, 3, 3)).astype(np.float32)
    if kind != "generic":
        r = 2 if kind == "rank2" else 1
        a = rs.normal(size=(16, 3, r)).astype(np.float32)
        b = rs.normal(size=(16, r, 3)).astype(np.float32)
        H = a @ b
    Rj, okj = jl.so3_procrustes(jnp.asarray(H))
    Rt, okt = tl.so3_procrustes(torch.from_numpy(H))
    # eigenvectors of H^T H move by rounding / (gap of squared singular
    # values): 1e-4 on random matrices. Rank 1 leaves the rotation
    # undetermined and `ok` to the rounding of a zero singular value.
    if kind != "rank1":
        np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
        assert okt.all()
        np.testing.assert_allclose(np.asarray(Rj), Rt.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(
            (Rt @ Rt.transpose(-1, -2)).numpy(),
            np.broadcast_to(np.eye(3, dtype=np.float32), (16, 3, 3)),
            atol=1e-5)
    Hs = [[torch.from_numpy(np.ascontiguousarray(H[:, i, j]))
           for j in range(3)] for i in range(3)]
    Rs, oks = tsoa.so3_procrustes(Hs)
    if kind != "rank1":
        np.testing.assert_array_equal(oks.numpy(), okt.numpy())
        np.testing.assert_allclose(tsoa.stack_mat3(Rs).numpy(), Rt.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_cholesky_and_smallest_eigvec():
    rs = np.random.default_rng(2)
    B = rs.normal(size=(8, 9, 20)).astype(np.float32)
    N = B @ B.transpose(0, 2, 1)
    Lj = jl.cholesky_unrolled(jnp.asarray(N))
    Lt = tl.cholesky_unrolled(torch.from_numpy(N))
    np.testing.assert_allclose(np.asarray(Lj), Lt.numpy(), rtol=1e-5,
                               atol=1e-5)
    b = rs.normal(size=(8, 9)).astype(np.float32)
    for lower in (True, False):
        xj = jl._tri_solve_unrolled(Lj, jnp.asarray(b), lower)
        xt = tl._tri_solve_unrolled(Lt, torch.from_numpy(b), lower)
        # triangular solves amplify the 1e-7 rounding of L by its condition
        np.testing.assert_allclose(np.asarray(xj), xt.numpy(), rtol=1e-4,
                                   atol=1e-4)
    ej = jl.smallest_eigvec_psd(jnp.asarray(N))
    et = tl.smallest_eigvec_psd(torch.from_numpy(N))
    np.testing.assert_allclose(np.asarray(ej), et.numpy(), rtol=1e-4,
                               atol=1e-4)
    # ties on the diagonal start from the FIRST smallest entry, as argmin
    D = np.broadcast_to(np.diag([3, 1, 2, 1, 5, 6, 7, 8, 9]).astype(
        np.float32), (2, 9, 9)).copy()
    np.testing.assert_allclose(
        np.asarray(jl.smallest_eigvec_psd(jnp.asarray(D))),
        tl.smallest_eigvec_psd(torch.from_numpy(D)).numpy(), **TOL)


def test_arun3_and_arun_3d3d_soa():
    _, _, P, Pb = _wide_pair(3, 64, 3)
    rs = np.random.default_rng(3)
    H = 32
    picks = np.stack([[rs.choice(64, 3, replace=False) for _ in range(H)]
                      for _ in range(3)])  # (C, H, 3)
    picks[0, 0] = [5, 5, 9]                # a degenerate (repeated) sample

    def samples(X):  # (3 points, 3 coords, C, H)
        return np.stack([np.stack([np.take_along_axis(
            X[:, i, :], picks[:, :, m], axis=1) for i in range(3)])
            for m in range(3)])

    ps, qs = samples(P), samples(Pb)
    Rj, tj, okj = jsoa.arun3(_to_lists(ps, jnp.asarray),
                             _to_lists(qs, jnp.asarray))
    Rt, tt, okt = tsoa.arun3(_to_lists(ps, torch.from_numpy),
                             _to_lists(qs, torch.from_numpy))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    assert not okt[0, 0]
    ok = okt.numpy()
    # three points: the Procrustes conditioning above, then
    # t = qbar - R pbar with coordinates up to ~6
    np.testing.assert_allclose(np.asarray(jsoa.stack_mat3(Rj))[ok],
                               tsoa.stack_mat3(Rt).numpy()[ok], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(jsoa.stack_vec(tj))[ok],
                               tsoa.stack_vec(tt).numpy()[ok], rtol=1e-4,
                               atol=1e-3)

    w = (rs.uniform(size=(3, 64)) < 0.7).astype(np.float32)
    Rb, tb, okb = tm.arun_3d3d_soa(torch.from_numpy(P), torch.from_numpy(Pb),
                                   torch.from_numpy(w))
    for c in range(3):
        Rr, tr, okr = jm.arun_3d3d_soa(jnp.asarray(P[c]), jnp.asarray(Pb[c]),
                                       jnp.asarray(w[c]))
        assert bool(okr) == bool(okb[c])
        np.testing.assert_allclose(np.asarray(Rr), Rb[c].numpy(), **TOL)
        np.testing.assert_allclose(np.asarray(tr), tb[c].numpy(), rtol=1e-5,
                                   atol=5e-5)


def test_essential8_soa():
    f1, f2, _, _ = _wide_pair(3, 64, 4)
    rs = np.random.default_rng(4)
    H = 32
    picks = np.stack([[rs.choice(64, 8, replace=False) for _ in range(H)]
                      for _ in range(3)])

    def samples(f):
        return np.stack([np.stack([np.take_along_axis(
            f[:, i, :], picks[:, :, m], axis=1) for i in range(3)])
            for m in range(8)])

    s1, s2 = samples(f1), samples(f2)
    Ej, okj = jsoa.essential8(_to_lists(s1, jnp.asarray),
                              _to_lists(s2, jnp.asarray))
    Et, okt = tsoa.essential8(_to_lists(s1, torch.from_numpy),
                              _to_lists(s2, torch.from_numpy))
    Ej = np.asarray(jsoa.stack_mat3(Ej))
    Et = tsoa.stack_mat3(Et).numpy()
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    # a minimal sample's normal matrix has rank 8 with lambda_2 as small
    # as the sample is close to degenerate: compare the well-conditioned
    # samples (lambda_2 > 1e-4 lambda_max, in float64) at 1e-3
    rows = np.einsum("mick,mjck->ckmij", s2.astype(np.float64),
                     s1.astype(np.float64)).reshape(3, H, 8, 9)
    ev = np.linalg.eigvalsh(np.einsum("chma,chmb->chab", rows, rows))
    good = ev[..., 1] > 1e-4 * ev[..., -1]
    assert good.sum() > H
    _close_up_to_sign(Ej[good], Et[good], 1e-3)
    assert np.isfinite(Et).all()


def test_essential_8pt_soa_and_sampson():
    f1, f2, _, _ = _wide_pair(4, 96, 5)
    rs = np.random.default_rng(5)
    w = (rs.uniform(size=(4, 96)) < 0.7).astype(np.float32)
    Eb, okb = tm.essential_8pt_soa(torch.from_numpy(f1), torch.from_numpy(f2),
                                   torch.from_numpy(w))
    err_b = tm.sampson_error_soa(Eb, torch.from_numpy(f1),
                                 torch.from_numpy(f2))
    for c in range(4):
        Er, okr = jm.essential_8pt_soa(jnp.asarray(f1[c]), jnp.asarray(f2[c]),
                                       jnp.asarray(w[c]))
        assert bool(okr) == bool(okb[c]) is True
        _close_up_to_sign(np.asarray(Er), Eb[c].numpy(), 1e-4)
        # the same E through both Sampson forms: closed form, 1e-5
        ej = jm.sampson_error_soa(Er, jnp.asarray(f1[c]), jnp.asarray(f2[c]))
        et = tm.sampson_error_soa(torch.from_numpy(np.array(Er)),
                                  torch.from_numpy(f1[c]),
                                  torch.from_numpy(f2[c]))
        np.testing.assert_allclose(np.asarray(ej), et.numpy(), rtol=1e-4,
                                   atol=1e-9)
        assert float(err_b[c].max()) < 1e-5   # noise 3e-4 -> err ~1e-7
    # w=None is uniform weights
    E1, _ = tm.essential_8pt_soa(torch.from_numpy(f1), torch.from_numpy(f2))
    E2, _ = tm.essential_8pt_soa(torch.from_numpy(f1), torch.from_numpy(f2),
                                 torch.ones(4, 96))
    np.testing.assert_array_equal(E1.numpy(), E2.numpy())


def test_project_essential():
    rs = np.random.default_rng(6)
    E = rs.normal(size=(16, 3, 3)).astype(np.float32)
    Ej, okj = jm._project_essential(jnp.asarray(E))
    Et, okt = tm._project_essential(torch.from_numpy(E))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    np.testing.assert_allclose(np.asarray(Ej), Et.numpy(), **TOL)
    s = np.linalg.svd(Et.numpy(), compute_uv=False)
    np.testing.assert_allclose(s, np.broadcast_to([1, 1, 0], s.shape),
                               atol=1e-5)
