"""Stiefel-manifold operations for rank-lifted pose-graph optimization
(the JAX package's core/stiefel.py).

A lifted pose block is Y = (..., r, d+1): columns 0..d-1 are the lifted
rotation (a point of St(d, r)), column d the lifted translation. All
operations broadcast over leading batch axes.
"""

from __future__ import annotations

import torch

from . import rng


def sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def stiefel_project(M: torch.Tensor) -> torch.Tensor:
    """Project (..., r, d) onto St(d, r) by the polar decomposition (the
    closest orthonormal-column matrix). d = 3 takes the closed-form 3x3
    polar factor, any other d an SVD."""
    if M.shape[-1] == 3:
        from ..kernels.linalg import polar_orthonormalize

        return polar_orthonormalize(M)
    U, _, Vt = torch.linalg.svd(M, full_matrices=False)
    return U @ Vt


def stiefel_tangent_project(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Project V onto the tangent space of St(d, r) at Y:
    V - Y sym(Y^T V)."""
    return V - Y @ sym(Y.transpose(-1, -2) @ V)


def stiefel_retract(Y: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Retraction: metric projection of Y + V back onto the manifold."""
    return stiefel_project(Y + V)


def lifted_tangent_project(Y: torch.Tensor, V: torch.Tensor,
                           d: int) -> torch.Tensor:
    """Tangent projection of a lifted block (..., r, d+1): Stiefel on the
    rotation columns, identity on the translation column."""
    VR_t = stiefel_tangent_project(Y[..., :d], V[..., :d])
    return torch.cat([VR_t, V[..., d:]], dim=-1)


def lifted_retract(Y: torch.Tensor, V: torch.Tensor, d: int) -> torch.Tensor:
    """Retract a lifted block: polar-retract the rotation columns, add the
    translation column."""
    YR = stiefel_retract(Y[..., :d], V[..., :d])
    return torch.cat([YR, Y[..., d:] + V[..., d:]], dim=-1)


def random_lifting_matrix(key: torch.Tensor, r: int, d: int,
                          dtype=torch.float32) -> torch.Tensor:
    """A lifting matrix YLift in St(d, r), deterministic given `key`
    (2,): the QR factor of a normal (r, d) draw (`rng.normal`, the draw
    `jax.random.normal` makes), column signs fixed by diag(R). On the
    device of `key`."""
    G = rng.normal(key, (r, d)).to(dtype)
    Q, R = torch.linalg.qr(G)
    s = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    s = torch.where(s == 0, 1.0, s)
    return Q * s[..., None, :]


def lift_poses(R: torch.Tensor, t: torch.Tensor,
               ylift: torch.Tensor) -> torch.Tensor:
    """Lift SE(3) poses (R (..., d, d), t (..., d)) to (..., r, d+1) with
    the shared lifting matrix ylift (r, d): Y = YLift [R | t]."""
    Rt = torch.cat([R, t[..., None]], dim=-1)  # (..., d, d+1)
    return torch.einsum("rd,...de->...re", ylift, Rt)


def round_solution(Y: torch.Tensor, d: int):
    """Round lifted poses back to SE(d): the dominant rank-d subspace A of
    all rotation blocks (SVD of the (r, n d) stack), its reflection gauge
    fixed by the mean determinant, then each block A^T Y_R projected onto
    SO(d). Returns (R (..., d, d), t (..., d)), up to a global rotation."""
    r = Y.shape[-2]
    YR = Y[..., :d]  # (..., r, d)
    stacked = YR.reshape(-1, r, d).transpose(0, 1).reshape(r, -1)
    U, _, _ = torch.linalg.svd(stacked, full_matrices=False)
    A = U[:, :d]  # (r, d)
    R_amb0 = torch.einsum("rd,...re->...de", A, YR)
    mean_det = torch.mean(torch.linalg.det(R_amb0.reshape(-1, d, d)))
    flip = torch.where(mean_det < 0.0, -1.0, 1.0)
    A = torch.cat([A[:, :-1], A[:, -1:] * flip], dim=-1)
    R_amb = torch.einsum("rd,...re->...de", A, YR)  # (..., d, d)
    from .lie import so3_project

    R = so3_project(R_amb) if d == 3 else _so_project_general(R_amb)
    t = torch.einsum("rd,...r->...d", A, Y[..., d])
    return R, t


def _so_project_general(M: torch.Tensor) -> torch.Tensor:
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    diag = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    diag = torch.cat([diag[..., :-1], det[..., None]], dim=-1)
    return (U * diag[..., None, :]) @ Vt
