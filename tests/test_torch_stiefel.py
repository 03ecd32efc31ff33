"""The port's Lie-group layer (`core/lie.py`), Stiefel layer
(`core/stiefel.py`), `linalg.polar_orthonormalize` and `rng.normal`
against the JAX package's, on shared numpy inputs, on the CPU.

Tolerances: elementwise float32 maps (hat / vee, exp, log, quaternions)
within 2e-6 absolute, 1e-5 near pi, where both packages take the
symmetric-part branch of so3_log and its axis carries a few ulp of the
trace's rounding (as does the geodesic distance, an arccos near pi); the
SVD-based projections within 1e-5 (two LAPACK calls); polar retraction
within 2e-6. `rng.normal` differs from `jax.random.normal` by at most 3
ulp (XLA's own float32 log1p; the erfinv polynomial and its fused
multiply-adds are XLA's), on at most 2 % of the draws; the lifting
matrix's QR then stays within 5e-7. `round_solution` is compared after
the left gauge of each package is
removed (R2_i = G R_i, G from pose 0)."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.core import lie as jlie, rng as jrng
from kimera_multi_tpu.core import stiefel as jst
from kimera_multi_tpu.kernels import linalg as jlinalg
from kimera_multi_tpu_torch.core import lie, rng, stiefel
from kimera_multi_tpu_torch.kernels import linalg

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

T = torch.from_numpy


def _rotvecs(seed=0, n=64):
    """Axis-angle vectors: generic, tiny (below 1e-4 rad), exactly zero,
    and within 1e-3 of pi."""
    npr = np.random.default_rng(seed)
    axis = npr.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.concatenate([npr.uniform(0.01, 3.0, n // 2),
                          npr.uniform(0, 5e-5, n // 4 - 1), [0.0],
                          np.pi - npr.uniform(0, 5e-4, n - n // 2 - n // 4)])
    return (axis * ang[:, None]).astype(np.float32), ang


_JAX = SimpleNamespace(lie=jlie, st=jst, la=jlinalg)
_PORT = SimpleNamespace(lie=lie, st=stiefel, la=linalg)


def _quantity(m, name, w, q, xi, A, B, p, Y):
    """One quantity of package `m` (the JAX package's or the port's
    modules) on the inputs of `_inputs`."""
    L = m.lie
    se3 = lambda: L.se3_exp(xi)
    between = lambda: L.se3_between(L.so3_exp(w), xi[:, 3:], *se3())
    return {
        "hat": lambda: L.hat(w),
        "vee": lambda: L.vee(L.hat(w)),
        "exp": lambda: L.so3_exp(w),
        "log": lambda: L.so3_log(L.so3_exp(w)),
        "q2r": lambda: L.quat_to_rot(q),
        "r2q": lambda: L.rot_to_quat(L.so3_exp(w)),
        "se3_R": lambda: se3()[0],
        "se3_t": lambda: se3()[1],
        "se3_log": lambda: L.se3_log(*se3()),
        "between_R": lambda: between()[0],
        "between_t": lambda: between()[1],
        "apply": lambda: L.se3_apply(*se3(), p),
        "proj": lambda: L.so3_project(A),
        "geo": lambda: L.rotation_geodesic_distance(L.so3_exp(w),
                                                    L.quat_to_rot(q)),
        "polar": lambda: m.la.polar_orthonormalize(B[..., :3]),
        "retract": lambda: m.st.lifted_retract(Y, 0.1 * B[..., 4:], 3),
        "tangent": lambda: m.st.lifted_tangent_project(B[..., :4],
                                                       B[..., 4:], 3),
    }[name]()


@functools.lru_cache(maxsize=1)
def _inputs():
    npr = np.random.default_rng(1)
    w, ang = _rotvecs()
    q = npr.normal(size=(64, 4)).astype(np.float32)
    xi = np.concatenate([w, npr.normal(size=(64, 3)).astype(np.float32)], 1)
    A = npr.normal(size=(64, 3, 3)).astype(np.float32)
    B = npr.normal(size=(64, 5, 8)).astype(np.float32)
    p = npr.normal(size=(64, 3)).astype(np.float32)
    # a lifted block on the manifold: polar factor | translation
    U, _, Vt = np.linalg.svd(B[..., :3].astype(np.float64),
                             full_matrices=False)
    Y = np.concatenate([(U @ Vt).astype(np.float32), B[..., 3:4]], -1)
    return ang, (w, q, xi, A, B, p, Y)


def _both(name):
    """The quantity in both packages; the JAX function is compiled for
    this quantity alone."""
    _, ins = _inputs()
    ref = np.asarray(jax.jit(functools.partial(_quantity, _JAX, name))(*ins))
    got = _quantity(_PORT, name, *(T(x) for x in ins)).numpy()
    return ref, got


@pytest.mark.parametrize("name,atol", [
    ("hat", 0), ("vee", 0), ("exp", 2e-6), ("q2r", 2e-6), ("r2q", 2e-6),
    ("se3_R", 2e-6), ("se3_t", 2e-6), ("between_R", 2e-6),
    ("between_t", 1e-5), ("apply", 1e-5), ("proj", 1e-5), ("polar", 2e-6),
    ("retract", 2e-6), ("tangent", 2e-6), ("se3_log", 2e-5),
    ("geo", 1e-5)])
def test_lie_and_stiefel_match_jax(name, atol):
    ref, got = _both(name)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_so3_log_near_zero_and_pi_match_jax():
    ang = _inputs()[0]
    ref, got = _both("log")
    near_pi = ang > np.pi - 1e-3
    tiny = ang < 1e-4
    assert near_pi.sum() >= 10 and tiny.sum() >= 10
    np.testing.assert_allclose(got[~near_pi], ref[~near_pi], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(got[near_pi], ref[near_pi], rtol=0,
                               atol=1e-5)
    # and both recover the angle: |log(exp(w))| = |w|
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), ang, atol=2e-5)
    assert np.array_equal(got[ang == 0], np.zeros((1, 3), np.float32))


def test_polar_is_orthonormal():
    B = torch.from_numpy(np.random.default_rng(2).normal(
        size=(32, 7, 3)).astype(np.float32))
    Q = linalg.polar_orthonormalize(B)
    np.testing.assert_allclose((Q.transpose(-1, -2) @ Q).numpy(),
                               np.broadcast_to(np.eye(3), (32, 3, 3)),
                               atol=5e-6)
    # the polar factor is the closest: Q^T B is symmetric positive definite
    S = (Q.transpose(-1, -2) @ B).numpy()
    np.testing.assert_allclose(S, np.swapaxes(S, 1, 2), atol=2e-5)
    assert (np.linalg.eigvalsh(S.astype(np.float64)) > 0).all()


def test_normal_draws_match_jax_within_3_ulp():
    kj = jrng.derive(jrng.base_key(3), 11)
    kt = rng.derive(rng.base_key(3), 11)
    a = np.asarray(jax.random.normal(kj, (50, 400), jnp.float32))
    b = rng.normal(kt, (50, 400)).numpy()
    assert b.dtype == np.float32 and b.shape == (50, 400)
    ulp = np.abs(a.view(np.int32).astype(np.int64)
                 - b.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert (ulp > 0).mean() <= 0.02
    # batched keys: row i is the draw of key i
    keys = rng.derive(rng.base_key(3), torch.arange(3))
    rows = rng.normal(keys, (7,))
    for i in range(3):
        assert torch.equal(rows[i],
                           rng.normal(rng.derive(rng.base_key(3), i), (7,)))


def test_random_lifting_matrix_matches_jax():
    for seed, (r, d) in ((0, (5, 3)), (4, (7, 3)), (9, (4, 2))):
        kj = jrng.derive(jrng.base_key(seed), jrng.Stream.LIFTING)
        kt = rng.derive(rng.base_key(seed), rng.Stream.LIFTING)
        want = np.asarray(jst.random_lifting_matrix(kj, r, d))
        got = stiefel.random_lifting_matrix(kt, r, d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
        np.testing.assert_allclose(got.T @ got, np.eye(d), atol=1e-6)


def test_lift_and_round_solution_match_jax_up_to_gauge():
    npr = np.random.default_rng(5)
    w, _ = _rotvecs(seed=6, n=24)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t = npr.normal(size=(24, 3)).astype(np.float32)
    ylift = np.asarray(jst.random_lifting_matrix(
        jrng.derive(jrng.base_key(0), jrng.Stream.LIFTING), 5, 3))
    Yj = np.asarray(jst.lift_poses(jnp.asarray(R), jnp.asarray(t),
                                   jnp.asarray(ylift)))
    Yt = stiefel.lift_poses(T(R), T(t), T(ylift))
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=0, atol=2e-6)
    # a small perturbation off the manifold, then rounding
    Yp = Yj + 1e-3 * npr.normal(size=Yj.shape).astype(np.float32)
    Rj, tj = (np.asarray(x) for x in jst.round_solution(jnp.asarray(Yp), 3))
    Rt_, tt_ = (x.numpy() for x in stiefel.round_solution(T(Yp), 3))
    for Ra, ta in ((Rj, tj), (Rt_, tt_)):
        G = R[0] @ Ra[0].T  # left gauge against the truth
        np.testing.assert_allclose(G @ Ra, R, atol=5e-3)
    # each package's own gauge removed: R_0^T R_i and R_0^T t_i
    np.testing.assert_allclose(Rt_[0].T @ Rt_, Rj[0].T @ Rj, atol=1e-5)
    np.testing.assert_allclose(tt_ @ Rt_[0], tj @ Rj[0], atol=1e-5)
    assert np.allclose(np.linalg.det(Rt_), 1.0, atol=1e-5)
