"""The port's hypothesis scoring against the JAX package's (`*_ref` XLA
forms and the Pallas kernels in interpret mode) on shared numpy inputs.
On the CPU the port takes the plain version of its CUDA kernels.

Tolerance: none — counts are integers. The data keeps a clear margin
around the threshold (exact inliers at ~1e-6 of residual, everything else
at a residual that lands within float rounding of the threshold with
negligible probability), so summation order cannot move a count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_multi_tpu.kernels import score as js
from kimera_multi_tpu_torch.io.synthetic import _so3_exp_np
from kimera_multi_tpu_torch.kernels import score as ts

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core each oversubscribes
# the machine
torch.set_num_threads(1)


def _scene(C=3, K=75, H=37, seed=0):
    """Per candidate: a rigid pair (p, q = R p + t for 60% of the points,
    far-off clutter for the rest), unit bearings of both, and H hypotheses
    of which every fourth is the true model."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-4, 4, (C, 3, K)).astype(np.float32)
    p[:, 2] += 8.0
    R_true = _so3_exp_np(rs.normal(0, 0.4, (C, 3)))
    t_true = rs.uniform(-1, 1, (C, 3)).astype(np.float32)
    q = np.einsum("cij,cjk->cik", R_true, p) + t_true[:, :, None]
    out = rs.uniform(size=(C, K)) < 0.4
    q = np.where(out[:, None, :], q + rs.uniform(2, 5, (C, 3, K)), q)
    q = q.astype(np.float32)
    valid = rs.uniform(size=(C, K)) < 0.85
    R_h = _so3_exp_np(rs.normal(0, 0.6, (C, H, 3)))
    t_h = rs.uniform(-1, 1, (C, H, 3)).astype(np.float32)
    R_h[:, ::4], t_h[:, ::4] = R_true[:, None], t_true[:, None]
    f1 = p / np.linalg.norm(p, axis=1, keepdims=True)
    f2 = q / np.linalg.norm(q, axis=1, keepdims=True)
    # E with f2^T E f1 = 0 for q = R p + t:  E = [t]x R
    tx = np.zeros((C, 3, 3), np.float32)
    tx[:, 0, 1], tx[:, 0, 2] = -t_true[:, 2], t_true[:, 1]
    tx[:, 1, 0], tx[:, 1, 2] = t_true[:, 2], -t_true[:, 0]
    tx[:, 2, 0], tx[:, 2, 1] = -t_true[:, 1], t_true[:, 0]
    E_true = tx @ R_true
    E_h = rs.normal(size=(C, H, 3, 3)).astype(np.float32)
    E_h[:, ::4] = E_true[:, None]
    return dict(p=p, q=q, valid=valid, R_h=R_h.astype(np.float32), t_h=t_h,
                f1=f1.astype(np.float32), f2=f2.astype(np.float32),
                E_h=E_h.astype(np.float32), n_in=((~out) & valid).sum(1))


@pytest.mark.parametrize("path", ["ref", "interpret"])
@pytest.mark.parametrize("K,H", [(75, 37), (128, 64)])
def test_rigid_counts(path, K, H):
    s = _scene(K=K, H=H)
    out = ts.rigid_counts(*(torch.from_numpy(s[k]) for k in
                            ("R_h", "t_h", "p", "q", "valid")), 0.3)
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, H)
    for c in range(3):
        args = [jnp.asarray(s[k][c]) for k in ("R_h", "t_h", "p", "q",
                                               "valid")]
        ref = (js.rigid_counts_ref(*args, 0.3) if path == "ref" else
               js.rigid_counts(*args, 0.3, interpret=True))
        np.testing.assert_array_equal(np.asarray(ref), out[c].numpy())
        # the true model counts at least the uncorrupted valid points
        assert (out[c, ::4] >= int(s["n_in"][c])).all()


@pytest.mark.parametrize("path", ["ref", "interpret"])
@pytest.mark.parametrize("K,H", [(75, 37), (128, 64)])
def test_essential_counts(path, K, H):
    s = _scene(K=K, H=H, seed=1)
    out = ts.essential_counts(*(torch.from_numpy(s[k]) for k in
                                ("E_h", "f1", "f2", "valid")), 1e-6)
    assert out.dtype == torch.int32 and tuple(out.shape) == (3, H)
    for c in range(3):
        args = [jnp.asarray(s[k][c]) for k in ("E_h", "f1", "f2", "valid")]
        ref = (js.essential_counts_ref(*args, 1e-6) if path == "ref" else
               js.essential_counts(*args, 1e-6, interpret=True))
        np.testing.assert_array_equal(np.asarray(ref), out[c].numpy())
        assert (out[c, ::4] >= int(s["n_in"][c])).all()


def test_counts_ignore_invalid_and_empty():
    s = _scene()
    none = torch.zeros(3, 75, dtype=torch.bool)
    assert (ts.rigid_counts(*(torch.from_numpy(s[k]) for k in
                              ("R_h", "t_h", "p", "q")), none, 0.3) == 0).all()
    assert (ts.essential_counts(*(torch.from_numpy(s[k]) for k in
                                  ("E_h", "f1", "f2")), none, 1e-6) == 0).all()


# K7's decision rule (kernels/csrc/score.cu, `presel_counts_kernel`), in
# numpy float32: err = n / d < thr decided by n < RN(RN(thr (1 - 2^-20)) d)
# (counted) or n > RN(RN(thr (1 + 2^-20)) d) (not counted), the division
# only between; taken for 2^-60 <= thr <= 1, the division always otherwise
_BELOW, _ABOVE = np.float32(1 - 2.0 ** -20), np.float32(1 + 2.0 ** -20)


def _presel_rule(n, d, thr):
    """The kernel's count decision, replayed in its order: (decision,
    whether the division was taken)."""
    thr = np.float32(thr)
    if not 2.0 ** -60 <= thr <= 1.0:
        return n / d < thr, np.ones(n.shape, bool)
    inside = n < (thr * _BELOW) * d
    undecided = ~(inside | (n > (thr * _ABOVE) * d))
    return np.where(undecided, n / d < thr, inside), undecided


@pytest.mark.parametrize("thr", [
    1e-6, 0.05, 0.0625, 1.0, 2.0 ** -60,
    # thr * d at the bottom of the normal range, a subnormal thr, thr > 1:
    # the rule is not taken
    1.2e-26, 1e-40, 3.0])
def test_presel_rule_equals_division(thr):
    """Every (n, d) with n walked over +-64 ulps of RN(thr d), for d
    log-uniform from the clamp value 1e-12 to 1e38 and at 1e-12, FLT_MAX / 3,
    FLT_MAX and inf, plus 0, subnormal, NaN and +-inf operands: the rule
    decides as n / d < thr does."""
    f32 = np.float32
    big = np.finfo(f32).max
    rs = np.random.default_rng(0)
    d = np.concatenate([10.0 ** rs.uniform(-12, 38, 1024),
                        [1e-12, big / 3, big, np.inf]]).astype(f32)
    with np.errstate(all="ignore"):
        p = f32(thr) * d
        steps = np.arange(-64, 65, dtype=np.int32)
        n = (p.view(np.int32)[:, None] + steps).view(f32)
        n = np.concatenate([n, np.broadcast_to(np.array(
            [0, 1e-45, 1e-38, 1.0, big, np.inf, np.nan], f32), (len(d), 7))],
            1)
        n, dd = np.broadcast_arrays(n, d[:, None])
        n = np.concatenate([n.ravel(), [1.0, np.nan, np.inf]]).astype(f32)
        dd = np.concatenate([dd.ravel(), [np.nan, 1.0, np.inf]]).astype(f32)
        got, divided = _presel_rule(n, dd, thr)
        np.testing.assert_array_equal(got, n / dd < f32(thr))
    if 2.0 ** -60 <= thr <= 1.0:
        # both branches run: the walk crosses the band of about 8 ulps
        # on either side where the rule divides
        assert 0 < divided.mean() < 0.3
