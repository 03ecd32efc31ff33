"""Graduated non-convexity with a truncated-least-squares (TLS) robust
cost (the JAX package's solve/gnc.py).

GNC-TLS weight update over all edges at once:

    w(r^2) = 1                                  if r^2 <= (mu/(mu+1)) barc^2
           = 0                                  if r^2 >= ((mu+1)/mu) barc^2
           = barc sqrt(mu(mu+1)) / |r| - mu     otherwise

with mu_0 = barc^2 / (2 r_max^2 - barc^2) and mu <- mu_factor mu each
outer iteration. Odometry edges are never down-weighted.
"""

from __future__ import annotations

import torch

from ..core.containers import EDGE_ODOMETRY, GncState

_EPS = 1e-12

_CHI2 = {
    (0.9, 6): 10.6446,
    (0.95, 6): 12.5916,
    (0.99, 6): 16.8119,
    (0.9, 3): 6.2514,
    (0.95, 3): 7.8147,
    (0.9, 1): 2.7055,
}


def barc2_from_quantile(alpha: float = 0.9, dof: int = 6) -> float:
    """Inlier threshold from a chi-square quantile (alpha = `gnc_alpha`),
    from a small table of the dofs in use (6 = SE(3) residual, 3, 1)."""
    key = (round(float(alpha), 4), int(dof))
    if key not in _CHI2:
        raise ValueError(f"no chi2 entry for alpha={alpha}, dof={dof}")
    return _CHI2[key]


def gnc_init(sq_errors: torch.Tensor, etype: torch.Tensor,
             valid: torch.Tensor, barc2: float) -> GncState:
    """mu_0 = barc^2 / (2 r_max^2 - barc^2) from the worst loop-closure
    residual at the initial solution, clipped to [1e-6, 1e6]."""
    lc = valid & (etype != EDGE_ODOMETRY)
    r2max = torch.max(torch.where(lc, sq_errors, 0.0))
    mu0 = barc2 / torch.clamp(2.0 * r2max - barc2, min=_EPS)
    return GncState(
        mu=torch.clamp(mu0, 1e-6, 1e6),
        weights=torch.ones_like(sq_errors),
        barc2=torch.tensor(barc2, dtype=sq_errors.dtype,
                           device=sq_errors.device),
        outer_iter=torch.tensor(0, dtype=torch.int32,
                                device=sq_errors.device))


def gnc_update_weights(state: GncState, sq_errors: torch.Tensor,
                       etype: torch.Tensor, valid: torch.Tensor,
                       mu_factor: float = 1.4) -> GncState:
    """One GNC outer iteration: recompute the TLS weights, anneal mu."""
    mu, barc2 = state.mu, state.barc2
    lo = mu / (mu + 1.0) * barc2
    hi = (mu + 1.0) / mu * barc2
    r = torch.sqrt(torch.clamp(sq_errors, min=_EPS))
    w_mid = torch.sqrt(barc2 * mu * (mu + 1.0)) / r - mu
    w = torch.where(sq_errors <= lo, 1.0,
                    torch.where(sq_errors >= hi, 0.0,
                                torch.clamp(w_mid, 0.0, 1.0)))
    w = torch.where(etype == EDGE_ODOMETRY, 1.0, w)
    w = torch.where(valid, w, 0.0)
    return GncState(mu=mu * mu_factor, weights=w, barc2=barc2,
                    outer_iter=state.outer_iter + 1)
