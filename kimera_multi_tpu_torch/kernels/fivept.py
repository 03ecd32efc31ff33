"""Five-point model generation and preselect scoring.

The mono-RANSAC model generator of the default (5-point) gate: per minimal
sample of 5 correspondences, the 5 x 9 epipolar design's 4-dim right
nullspace (5 unrolled Householder reflections), then `n_starts`
deterministic combinations of the basis polished by Gauss-Newton on the
essential variety (`soa.essential5_polish_soa`). Preemptive scoring counts
the Sampson inliers of every (hypothesis, start) model over the first
`preselect_pts` valid correspondences; `select_models` keeps the best.

Layouts are the JAX package's, with a leading candidate axis C:

  samples   (C, 15, H) per side, row 3 j + d = coordinate d of sample j
            (`gather.sample_gather_perm_t` at k = 5)
  models    (C, 9 S, H) raw model rows, entry-major: row e * S + s is
            entry (e // 3, e % 3) of start s's model
  counts    (C, H, S) int32

`fivept_models` (csrc/fivept.cu) and `presel_counts` (csrc/score.cu) are
hand-written CUDA kernels for tensors on the card; for CPU tensors the
plain versions below run. Both plain versions are written operation for
operation in the kernels' order. `presel_counts` is exact: its kernel is
built without FMA contraction and divides only where a cheaper comparison
cannot decide the count (the rule and its proof are in csrc/score.cu).
`fivept_models` contracts and is held to its plain version by a stated
tolerance (`chip_smoke.py`, tests/test_torch_cuda_kernels.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, score, soa

_EPS = 1e-12
_MAX_STARTS = 16

# deterministic multi-start directions (coefficients of the nullspace
# combination), normalised in float32 exactly as the JAX package does
_STARTS = np.asarray(
    [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1],
        [2, 1, 0, -1], [-1, 2, 1, 0], [0, -1, 2, 1], [1, 0, -1, 2],
        [1, 2, -2, 1], [-2, 1, 1, 2], [1, -2, 1, 2], [2, 2, 1, -1],
    ],
    np.float32,
)
_STARTS = _STARTS / np.linalg.norm(_STARTS, axis=1, keepdims=True)

_STEP_CAP = 0.4
_DAMPING = 1e-6


def _nullspace_rows5_soa(rows):
    """Right-nullspace basis of the 5 x 9 design, lane-major.

    rows: list of 5 lists of 9 tensors. 5 unrolled Householder reflections
    on A = rows^T, then back-application onto e_5..e_8. Returns
    basis[s][i] (s in 0..3, i in 0..8). Sums run left to right from their
    first term (`soa._sum`), as in the kernel."""
    n, k = 9, 5
    A = [[rows[j][i] for j in range(k)] for i in range(n)]  # A[i][j]
    vs = []
    for j in range(k):
        alpha2 = soa._sum(A[i][j] * A[i][j] for i in range(j, n))
        alpha = torch.sqrt(torch.clamp(alpha2, min=_EPS))
        sign = torch.where(A[j][j] >= 0, 1.0, -1.0)
        v = [None] * n
        for i in range(j, n):
            v[i] = A[j][j] + sign * alpha if i == j else A[i][j]
        vn = torch.sqrt(torch.clamp(
            soa._sum(v[i] * v[i] for i in range(j, n)), min=_EPS))
        inv = 1.0 / vn
        for i in range(j, n):
            v[i] = v[i] * inv
        vs.append((j, v))
        # A -= 2 v (v^T A)
        for c in range(k):
            coef = 2.0 * soa._sum(v[i] * A[i][c] for i in range(j, n))
            for i in range(j, n):
                A[i][c] = A[i][c] - v[i] * coef
    zero = torch.zeros_like(rows[0][0])
    one = torch.ones_like(rows[0][0])
    basis = []
    for col in range(k, n):
        # q = e_col, back-apply the reflections in reverse order; the
        # reflection with pivot j touches entries i >= j only
        q = [zero] * n
        q[col] = one
        for j, v in reversed(vs):
            dot = soa._sum(v[i] * q[i] for i in range(j, n))
            for i in range(j, n):
                q[i] = q[i] - 2.0 * v[i] * dot
        basis.append(q)
    return basis


def _check_starts(n_starts: int) -> None:
    if not 1 <= n_starts <= _MAX_STARTS:
        raise ValueError(f"n_starts must be in 1..{_MAX_STARTS}")


def _fivept_models_ref(f1s, f2s, n_starts: int, gn_iters: int,
                       project: bool = True):
    """Plain version of `fivept_models` (same layout and algebra)."""
    _check_starts(n_starts)
    # design rows: row_j = outer(f2_j, f1_j).ravel(), entry 3 r + c;
    # entries (C, 1, H), the start axis broadcasts in the middle
    rows = [[f2s[:, None, 3 * j + r] * f1s[:, None, 3 * j + c]
             for r in range(3) for c in range(3)]
            for j in range(5)]
    B9 = _nullspace_rows5_soa(rows)
    starts = torch.from_numpy(_STARTS[:n_starts]).to(f1s.device)
    q0 = [starts[:, comp].reshape(1, n_starts, 1) for comp in range(4)]
    q = soa.essential5_polish_soa(B9, q0, n_iters=gn_iters,
                                  step_cap=_STEP_CAP, damping=_DAMPING)
    E9 = [soa._sum(q[s] * B9[s][i] for s in range(4)) for i in range(9)]
    out = torch.cat(E9, dim=1)  # (C, 9 S, H)
    return _project_rows(out, n_starts) if project else out


def _project_rows(E_rows: torch.Tensor, n_starts: int) -> torch.Tensor:
    """Essential-manifold projection of (C, 9 S, H) raw model rows."""
    S = n_starts
    E9 = [E_rows[:, e * S:(e + 1) * S] for e in range(9)]
    Eproj, _ok = soa.project_essential_soa(E9)
    return torch.cat([Eproj[e // 3][e % 3] for e in range(9)], dim=1)


def fivept_models(f1s: torch.Tensor, f2s: torch.Tensor, n_starts: int = 8,
                  gn_iters: int = 12, project: bool = True) -> torch.Tensor:
    """Essential models from SoA minimal samples.

    f1s, f2s: (C, 15, H) — 5 sample bearings per hypothesis,
    component-major. Returns (C, 9 * n_starts, H): row e * n_starts + s is
    entry (e // 3, e % 3) of the s-th start's model — manifold-projected
    when `project` is True, raw polished combinations otherwise (the
    preselect path scores raw models and projects only the survivors).
    The kernel computes the raw rows; the projection runs as plain tensor
    code on either path.
    """
    if f1s.device.type == "cpu":
        return _fivept_models_ref(f1s, f2s, n_starts, gn_iters,
                                  project=project)
    _check_starts(n_starts)
    C, _, H = f1s.shape
    _build.check_cuda("f1s", f1s, torch.float32, (C, 15, H))
    _build.check_cuda("f2s", f2s, torch.float32, (C, 15, H))
    if C > 65535:
        raise ValueError("fivept_models: C at most 65535")
    starts = torch.from_numpy(_STARTS[:n_starts]).to(f1s.device)
    out = torch.empty((C, 9 * n_starts, H), dtype=torch.float32,
                      device=f1s.device)
    with torch.cuda.device(f1s.device):
        _build.launch("fivept_models", f1s.data_ptr(), f2s.data_ptr(),
                      starts.data_ptr(), out.data_ptr(), C, H, n_starts,
                      gn_iters, _STEP_CAP, _DAMPING)
    return _project_rows(out, n_starts) if project else out


def models_to_flat(E_rows: torch.Tensor, n_starts: int) -> torch.Tensor:
    """(C, 9 S, H) model rows -> (C, H * S, 3, 3) model table in the
    (hypothesis-major, start-minor) order RANSAC scoring flattens to."""
    S = n_starts
    C, _, H = E_rows.shape
    return (E_rows.reshape(C, 3, 3, S, H)
            .permute(0, 4, 3, 1, 2)
            .reshape(C, H * S, 3, 3))


def presel_counts_ref(E_rows, f1p, f2p, validp, threshold, n_starts):
    """Plain version of `presel_counts`: the Sampson counts of
    `score.essential_counts_ref` on the flattened model table."""
    C, _, H = E_rows.shape
    flat = models_to_flat(E_rows, n_starts)
    c = score.essential_counts_ref(flat, f1p, f2p, validp, threshold)
    return c.reshape(C, H, n_starts)


def presel_counts(E_rows: torch.Tensor, f1p: torch.Tensor,
                  f2p: torch.Tensor, validp: torch.Tensor, threshold: float,
                  n_starts: int) -> torch.Tensor:
    """Preselect Sampson-inlier counts for every (hypothesis, start).

    E_rows: (C, 9 S, H) raw model rows (`fivept_models(project=False)`);
    f1p, f2p: (C, 3, P) SoA preselect bearings; validp: (C, P) bool.
    Returns (C, H, S) int32 counts, read in place from the entry-major
    rows (no model table is written).
    """
    if E_rows.device.type == "cpu":
        return presel_counts_ref(E_rows, f1p, f2p, validp, threshold,
                                 n_starts)
    S = n_starts
    C, _, H = E_rows.shape
    P = f1p.shape[2]
    _build.check_cuda("E_rows", E_rows, torch.float32, (C, 9 * S, H))
    _build.check_cuda("f1p", f1p, torch.float32, (C, 3, P))
    _build.check_cuda("f2p", f2p, torch.float32, (C, 3, P))
    _build.check_cuda("validp", validp, torch.bool, (C, P))
    if C > 65535 or S > 65535:
        raise ValueError("presel_counts: C and n_starts at most 65535")
    out = torch.empty((C, H, S), dtype=torch.int32, device=E_rows.device)
    with torch.cuda.device(E_rows.device):
        _build.launch("presel_counts", E_rows.data_ptr(), f1p.data_ptr(),
                      f2p.data_ptr(), validp.data_ptr(), out.data_ptr(),
                      C, H, S, P, float(threshold))
    return out


def select_models(E_rows: torch.Tensor, counts: torch.Tensor, n_keep: int,
                  n_starts: int):
    """Per-hypothesis-best preemptive selection.

    counts: (C, H, S) preselect counts. Keeps each hypothesis's FIRST best
    start, then the `n_keep` best hypotheses in `jax.lax.top_k` order:
    descending count, the lower hypothesis index first on a tie (through
    an exact composite key, since `torch.topk` promises no tie order).
    Returns (E_sel (C, n_keep, 3, 3) RAW models, flat_idx (C, n_keep) into
    the h-major (H S) model table)."""
    S = n_starts
    C, H, _ = counts.shape
    best_s = score.first_argmax(counts)                        # (C, H)
    best_c = torch.max(counts, dim=-1).values.long()
    ar = torch.arange(H, device=counts.device)
    key = best_c * H + (H - 1 - ar)                       # unique per h
    top_h = torch.topk(key, n_keep, dim=1, sorted=True).indices
    s_sel = torch.gather(best_s, 1, top_h)
    cols = (s_sel * H + top_h)[:, None, :].expand(C, 9, n_keep)
    ent = torch.gather(E_rows.reshape(C, 9, S * H), 2, cols)  # (C, 9, n)
    E_sel = ent.transpose(1, 2).reshape(C, n_keep, 3, 3)
    return E_sel, top_h * S + s_sel

