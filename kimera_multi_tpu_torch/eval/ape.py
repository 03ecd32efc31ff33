"""Absolute pose error, the evo-equivalent acceptance metric (the JAX
package's eval/ape.py).

Associate estimate and ground truth by timestamp (max_diff 0.01 s),
SE(3)-align the positions (Umeyama, no scale), then the translation RMSE
and the full-pose RMSE (evo_real_time.py's live evaluation).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import backend, lie
from ..kernels.linalg import so3_procrustes


class ApeResult(NamedTuple):
    rmse_trans: float
    mean_trans: float
    max_trans: float
    rmse_full: float  # full-SE(3) APE (evo "full" metric: ||T_err - I||_F)
    n_matched: int


def align_left(R_ref0, t_ref0, R_est0, t_est0, R_est, t_est):
    """Left-multiplicative gauge alignment: T_a = T_ref0 T_est0^-1, then
    T_a T_est_i for every pose. Exact when estimate and reference differ
    by one global rigid transform."""
    Ri, ti = lie.se3_inverse(R_est0, t_est0)
    Ra, ta = lie.se3_compose(R_ref0, t_ref0, Ri, ti)
    n = R_est.shape[0]
    return lie.se3_compose(Ra.expand(n, 3, 3), ta.expand(n, 3), R_est,
                           t_est)


def umeyama_alignment(t_est: torch.Tensor, t_ref: torch.Tensor,
                      with_scale: bool = False):
    """SE(3) (optionally Sim(3)) alignment of point sets, evo-style.
    Returns (R, t, s) minimizing || t_ref - (s R t_est + t) ||."""
    mu_e = torch.mean(t_est, dim=0)
    mu_r = torch.mean(t_ref, dim=0)
    e = t_est - mu_e
    r = t_ref - mu_r
    H = e.T @ r / t_est.shape[0]  # maps est -> ref
    R, _ = so3_procrustes(H)
    if with_scale:
        var_e = torch.mean(torch.sum(e * e, dim=-1))
        s = torch.sum(r * torch.einsum("ij,kj->ki", R, e)) / torch.clamp(
            var_e * t_est.shape[0], min=1e-12)
    else:
        s = torch.ones((), dtype=t_est.dtype, device=t_est.device)
    t = mu_r - s * torch.einsum("ij,j->i", R, mu_e)
    return R, t, s


def associate(ts_est: np.ndarray, ts_ref: np.ndarray,
              max_diff: float = 0.01):
    """Nearest-timestamp association (evo `sync.associate_trajectories`,
    max_diff 0.01 s). Returns index arrays (into est, into ref)."""
    ts_est = np.asarray(ts_est, np.float64)
    ts_ref = np.asarray(ts_ref, np.float64)
    pos = np.searchsorted(ts_ref, ts_est)
    pos = np.clip(pos, 1, len(ts_ref) - 1)
    left, right = ts_ref[pos - 1], ts_ref[pos]
    choose_right = (ts_est - left) > (right - ts_est)
    idx_ref = np.where(choose_right, pos, pos - 1)
    diff = np.abs(ts_ref[idx_ref] - ts_est)
    keep = diff <= max_diff
    return np.nonzero(keep)[0], idx_ref[keep]


def ape(t_est: torch.Tensor, R_est: torch.Tensor, t_ref: torch.Tensor,
        R_ref: torch.Tensor, align: bool = True) -> ApeResult:
    """APE between already associated trajectories, on their device.

    The alignment fits positions only (evo's `traj_est.align`), so on a
    (near-)straight trajectory the roll about the track axis is
    unconstrained and `rmse_full` reports an arbitrary rotation offset;
    `rmse_trans` is always well posed."""
    if align:
        Ra, ta, _ = umeyama_alignment(t_est, t_ref)
        n = t_est.shape[0]
        R_est = Ra.expand(n, 3, 3) @ R_est
        t_est = torch.einsum("ij,kj->ki", Ra, t_est) + ta
    dt = t_est - t_ref
    d2 = torch.sum(dt * dt, dim=-1)
    # full metric: || T_ref^-1 T_est - I ||_F per pose
    Rrel = R_ref.transpose(-1, -2) @ R_est
    trel = torch.einsum("kji,kj->ki", R_ref, dt)
    eye = torch.eye(3, dtype=Rrel.dtype, device=Rrel.device)
    full2 = (torch.sum((Rrel - eye) ** 2, dim=(-1, -2))
             + torch.sum(trel * trel, dim=-1))
    return ApeResult(
        rmse_trans=float(torch.sqrt(torch.mean(d2))),
        mean_trans=float(torch.mean(torch.sqrt(d2))),
        max_trans=float(torch.max(torch.sqrt(d2))),
        rmse_full=float(torch.sqrt(torch.mean(full2))),
        n_matched=int(t_est.shape[0]))


def ape_from_tum(est_path: str, ref_path: str, max_diff: float = 0.01,
                 align: bool = True, device="cuda") -> ApeResult:
    """File-level entry: read two TUM files, associate, align, APE (on
    `device`, the card unless told otherwise; float32 as the JAX
    package)."""
    from ..io.logs import read_tum

    dev = backend.resolve_device(device)
    ts_e, t_e, q_e = read_tum(est_path)
    ts_r, t_r, q_r = read_tum(ref_path)
    ie, ir = associate(ts_e, ts_r, max_diff)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return ape(f(t_e[ie]), lie.quat_to_rot(f(q_e[ie])), f(t_r[ir]),
               lie.quat_to_rot(f(q_r[ir])), align)
