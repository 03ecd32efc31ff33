"""The port's five-point model generation (kernels/fivept.py and the polish
and projection of kernels/soa.py) against the JAX package's, on shared
numpy inputs. On the CPU the port takes the plain versions of its CUDA
kernels (K6 `fivept_models`, K7 `presel_counts`).

Tolerances, and why:
- nullspace + start combination (gn_iters=0): smooth arithmetic, but the
  Householder basis of a random 5-point design is conditioned so that
  float32 rounding moves entries by up to 2e-5 (each package against a
  float64 run of the same algorithm; 4 seeds measured): the packages agree
  within 5e-5 everywhere and within 1e-5 on at least 99.8 % of the
  entries.
- the essential-manifold projection goes through the analytic eigh3x3
  (acos, cos) of E^T E. Its eigenvectors amplify rounding where two
  eigenvalues are close: ulp differences of the input move up to 0.5 % of
  the entries by more than 1e-4 (measured up to 5e-3). Compared: at least
  98 % of the entries within 1e-5 and 99.5 % within 1e-4 (measured 0.990
  and 0.9975 at least, 3 seeds), the same `ok`
  flags, and every output an essential matrix. (On converged polish output
  E^T E has a double top eigenvalue and the projection is ill-conditioned
  in both packages; see ROADMAP Queue 3.)
- the polish (gn_iters > 0) is a root finder: a start near a basin
  boundary amplifies ulp differences into another (equally valid) root.
  Held to the contract of tests/test_fivept_kernel.py: nearly all entries
  agree within 1e-3, and on clean samples nearly every hypothesis has a
  start that fits its 5 sample constraints.
- counts and selections are integers: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.kernels import fivept as jf, soa as jsoa
from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import _build, fivept as tf, soa as tsoa

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)

S = 8
H = 64
C = 2


def _samples(C, H, seed):
    """Clean minimal samples: 5 bearing pairs per hypothesis of a rigid
    two-view scene, SoA (C, 15, H) per side (row 3 j + d = coordinate d of
    sample j)."""
    rs = np.random.default_rng(seed)
    P = rs.uniform(-3, 3, (C, H, 5, 3))
    P[..., 2] = rs.uniform(3, 9, (C, H, 5))
    R = _so3_exp_np(rs.normal(0, 0.3, (C, 3))).astype(np.float64)
    t = rs.uniform(-0.5, 0.5, (C, 3))
    P2 = np.einsum("chkj,cji->chki", P - t[:, None, None, :], R)  # R^T(P-t)
    f1 = P / np.linalg.norm(P, axis=-1, keepdims=True)
    f2 = P2 / np.linalg.norm(P2, axis=-1, keepdims=True)

    def soa(f):  # (C, H, 5, 3) -> (C, 15, H)
        return np.ascontiguousarray(
            f.transpose(0, 2, 3, 1).reshape(C, 15, H).astype(np.float32))

    return soa(f1), soa(f2)


@pytest.fixture(scope="module")
def samples():
    return _samples(C, H, seed=0)


@pytest.fixture(scope="module")
def jax_models():
    """The JAX reference path, jitted once: `gn_iters` is a traced loop
    bound, so every iteration count shares one compile."""
    fn = jax.jit(jax.vmap(jf._fivept_models_ref,
                          in_axes=(0, 0, None, None, None)),
                 static_argnums=(2, 4))
    return lambda f1, f2, it: np.asarray(
        fn(jnp.asarray(f1), jnp.asarray(f2), S, it, False))


@jax.jit
def _jax_polish_project(B9, q0, n_iters):
    """JAX polish (traced iteration count: one compile for every count),
    the start combination and the essential projection."""
    q = jsoa.essential5_polish_soa(B9, q0, n_iters=n_iters)
    E = [sum(q[s] * B9[s][i] for s in range(4)) for i in range(9)]
    return q, E, jsoa.project_essential_soa(E)


def _port(f1, f2, it, project=False, dtype=torch.float32):
    return tf.fivept_models(torch.from_numpy(f1).to(dtype),
                            torch.from_numpy(f2).to(dtype), n_starts=S,
                            gn_iters=it, project=project).numpy()


def _epipolar_resid(E_rows, f1, f2):
    """max over the 5 sample points of |f2^T E f1| per model -> (C, H, S)."""
    E = E_rows.reshape(C, 3, 3, S, H).transpose(0, 4, 3, 1, 2)
    a = f1.reshape(C, 5, 3, H).transpose(0, 3, 1, 2)  # (C, H, 5, 3)
    b = f2.reshape(C, 5, 3, H).transpose(0, 3, 1, 2)
    r = np.einsum("chkj,chsji,chki->chsk", b, E, a)
    return np.abs(r).max(-1)


def test_starts_table_is_the_reference_table():
    np.testing.assert_array_equal(tf._STARTS, jf._STARTS)


def test_fivept_models_without_polish_matches_jax(samples, jax_models):
    f1, f2 = samples
    ref = jax_models(f1, f2, 0)
    out = _port(f1, f2, 0)
    assert out.shape == (C, 9 * S, H) and out.dtype == np.float32
    f64 = _port(f1, f2, 0, dtype=torch.float64)
    assert np.abs(ref - f64).max() < 3e-5
    assert np.abs(out - f64).max() < 3e-5
    d = np.abs(ref - out)
    assert d.max() < 5e-5, d.max()
    assert (d < 1e-5).mean() >= 0.998, (d < 1e-5).mean()


def test_fivept_models_polished_contract(samples, jax_models):
    f1, f2 = samples
    ref = jax_models(f1, f2, 8)
    out = _port(f1, f2, 8)
    d = np.abs(ref - out)
    assert (d < 1e-3).mean() >= 0.98, (d < 1e-3).mean()
    # solver contract, for both packages: nearly every hypothesis has a
    # start whose polished model fits its clean minimal sample
    for E_rows in (ref, out):
        best = _epipolar_resid(E_rows, f1, f2).min(axis=-1)
        assert (best < 5e-4).mean() > 0.95, (best < 5e-4).mean()
    # project=True: every output is an essential matrix (s, s, 0)
    _assert_essential(tf.models_to_flat(
        torch.from_numpy(_port(f1, f2, 8, project=True)), S).numpy())


def test_fivept_models_matches_pallas_interpret(samples):
    """One small case against the JAX Pallas kernel in interpret mode."""
    f1, f2 = samples
    ref = np.asarray(jf.fivept_models(jnp.asarray(f1[0]), jnp.asarray(f2[0]),
                                      n_starts=S, gn_iters=0, interpret=True,
                                      project=False))
    d = np.abs(ref - _port(f1, f2, 0)[0])
    assert d.max() < 5e-5, d.max()
    assert (d < 1e-5).mean() >= 0.998


def _close_share(a, b, tol):
    return float((np.abs(np.asarray(a) - np.asarray(b)) < tol).mean())


def _assert_essential(E, atol=1e-4):
    sv = np.linalg.svd(np.asarray(E, np.float64).reshape(-1, 3, 3),
                       compute_uv=False)
    np.testing.assert_allclose(sv[:, 0], sv[:, 1], atol=atol)
    np.testing.assert_allclose(sv[:, 2], 0.0, atol=atol)


@pytest.mark.parametrize("n_iters", [0, 2])
def test_polish_and_projection_match_jax(samples, n_iters):
    """`essential5_polish_soa` from the SAME basis and starts, and
    `project_essential_soa` of the same combinations. The polish: equal at
    n_iters=0; after two steps at least 97 % of the q entries within 1e-5
    and all within 1e-3 (measured 0.98 and 5.3e-4 over 3 seeds). The
    projection: see the module docstring."""
    f1, f2 = samples
    rows = [[torch.from_numpy(f2[:, None, 3 * j + r] * f1[:, None, 3 * j + c])
             for r in range(3) for c in range(3)] for j in range(5)]
    B9 = [[e.numpy() for e in b] for b in tf._nullspace_rows5_soa(rows)]
    q0 = [np.broadcast_to(tf._STARTS[:S, k].reshape(1, S, 1), (C, S, H))
          .copy() for k in range(4)]

    qj, Ej, (Epj, okj) = _jax_polish_project(
        [[jnp.asarray(e) for e in b] for b in B9],
        [jnp.asarray(x) for x in q0], n_iters)
    qt = tsoa.essential5_polish_soa(
        [[torch.from_numpy(e) for e in b] for b in B9],
        [torch.from_numpy(x) for x in q0], n_iters=n_iters)
    qj = np.stack([np.asarray(a) for a in qj])
    qt = torch.stack(qt).numpy()
    assert np.abs(qj - qt).max() < 1e-3
    assert _close_share(qj, qt, 1e-5) >= (1.0 if n_iters == 0 else 0.97)
    Ept, okt = tsoa.project_essential_soa(
        [torch.from_numpy(np.array(e)) for e in Ej])
    Epj = np.stack([np.asarray(Epj[i][j]) for i in range(3) for j in range(3)])
    Ept = torch.stack([Ept[i][j] for i in range(3) for j in range(3)]).numpy()
    assert _close_share(Epj, Ept, 1e-5) >= 0.98
    assert _close_share(Epj, Ept, 1e-4) >= 0.995
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    _assert_essential(np.moveaxis(Ept, 0, -1))


def test_presel_counts_matches_jax():
    """Counts are exact arithmetic: the port's plain version, the JAX
    Pallas kernel in interpret mode and the JAX reference scoring, fed the
    SAME numpy model rows, agree element for element."""
    P = 64
    rs = np.random.default_rng(11)
    E_rows = rs.normal(size=(C, 9 * S, H)).astype(np.float32)
    f1 = rs.normal(size=(C, 3, P)).astype(np.float32)
    f2 = rs.normal(size=(C, 3, P)).astype(np.float32)
    valid = rs.uniform(size=(C, P)) > 0.2
    thr = 3e-2
    n0 = dict(_build.launches)
    out = tf.presel_counts(*(torch.from_numpy(x) for x in
                             (E_rows, f1, f2, valid)), thr, S)
    assert dict(_build.launches) == n0   # CPU tensors: the plain version
    assert tuple(out.shape) == (C, H, S) and out.dtype == torch.int32
    for c in range(C):
        args = (jnp.asarray(E_rows[c]), jnp.asarray(f1[c]),
                jnp.asarray(f2[c]), jnp.asarray(valid[c]), thr, S)
        np.testing.assert_array_equal(
            np.asarray(jf.presel_counts(*args, interpret=True)),
            out[c].numpy())
        np.testing.assert_array_equal(np.asarray(jf.presel_counts(*args)),
                                      out[c].numpy())
    assert int(out.sum()) > 0   # the threshold fires


def test_select_models_with_ties_matches_jax():
    """Heavy ties (counts in 0..3): the first best start per hypothesis,
    the best hypotheses in jax.lax.top_k order."""
    Hs, Ss, n_keep = 40, 4, 12
    rs = np.random.default_rng(3)
    E_rows = rs.normal(size=(C, 9 * Ss, Hs)).astype(np.float32)
    counts = rs.integers(0, 4, (C, Hs, Ss)).astype(np.int32)
    E_sel, flat = tf.select_models(torch.from_numpy(E_rows),
                                   torch.from_numpy(counts), n_keep, Ss)
    for c in range(C):
        Ej, fj = jf.select_models(jnp.asarray(E_rows[c]),
                                  jnp.asarray(counts[c]), n_keep, Ss)
        np.testing.assert_array_equal(np.asarray(fj), flat[c].numpy())
        np.testing.assert_array_equal(np.asarray(Ej), E_sel[c].numpy())


def test_models_to_flat_and_project_rows_match_jax(samples):
    f1, f2 = samples
    rows = _port(f1, f2, 2)
    flat = tf.models_to_flat(torch.from_numpy(rows), S).numpy()
    proj = tf._project_rows(torch.from_numpy(rows), S).numpy()
    project = jax.jit(jf._project_rows, static_argnums=1)
    for c in range(C):
        np.testing.assert_array_equal(
            np.asarray(jf.models_to_flat(jnp.asarray(rows[c]), S)), flat[c])
        pj = np.asarray(project(jnp.asarray(rows[c]), S))
        assert _close_share(pj, proj[c], 1e-4) >= 0.995
    # row e*S + s, column h -> flat[h*S + s, e // 3, e % 3]
    assert flat[1, 5 * S + 3, 2, 1] == rows[1, 7 * S + 3, 5]
    _assert_essential(tf.models_to_flat(torch.from_numpy(proj), S).numpy())


def test_n_starts_out_of_range_raises(samples):
    f1, f2 = (torch.from_numpy(x) for x in samples)
    with pytest.raises(ValueError, match="n_starts"):
        tf.fivept_models(f1, f2, n_starts=17, gn_iters=0)
