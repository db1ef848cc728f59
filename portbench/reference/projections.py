"""The constraint projections in plain PyTorch, over any leading axes.

The mathematics of ``animsnapbases_tpu_torch/sim/projections.py`` at
commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3 (itself the reference's
``Constraint_projections.py``), rewritten on ``torch.linalg.svd`` in place
of the program's own Jacobi routines: the projections are the same
functions of the positions, computed another way.

* tris_strain: F = P^T Ds DmInv (2x2), its singular values clamped to
  [sigma_min, sigma_max]; the projection's rows are the columns of
  P Fhat (3 x 2), row k of an element being column k.
* edge_spring: half the edge vector shortened to half its rest length.
* tets_deformation_gradient: F = Ds DmInv (3x3), R = U V^T with U's last
  column negated where det(U V^T) < 0; row k of an element is R[:, k].

Each function takes the vertex positions of its elements' corners,
``corners`` (..., m, c, 3), and the rest data of those m elements, and
returns all rows (..., m, p, 3).
"""

from __future__ import annotations

import torch


def tris_strain(corners, P, DmInv, sigma_min, sigma_max):
    Ds = torch.stack([corners[..., 1, :] - corners[..., 0, :],
                      corners[..., 2, :] - corners[..., 0, :]], dim=-1)
    F = P.transpose(-1, -2) @ Ds @ DmInv                       # (..., 2, 2)
    U, s, Vh = torch.linalg.svd(F)
    s = s.clamp(min=sigma_min, max=sigma_max)
    Fhat = (U * s[..., None, :]) @ Vh
    return (P @ Fhat).transpose(-1, -2)                        # (..., 2, 3)


def edge_spring(corners, rest_length):
    spring = corners[..., 1, :] - corners[..., 0, :]
    length = torch.linalg.vector_norm(spring, dim=-1, keepdim=True)
    safe = torch.where(length > 0, length, torch.ones_like(length))
    p = 0.5 * spring - 0.5 * (length - rest_length[..., None]) * spring / safe
    return torch.where(length > 0, p, torch.zeros_like(p))[..., None, :]


def tets_deformation_gradient(corners, DmInv):
    c4 = corners[..., 3, :]
    Ds = torch.stack([corners[..., 0, :] - c4, corners[..., 1, :] - c4,
                      corners[..., 2, :] - c4], dim=-1)
    F = Ds @ DmInv
    U, _, Vh = torch.linalg.svd(F)
    det = torch.linalg.det(U @ Vh)
    sign = torch.ones_like(U[..., :1, :])
    sign[..., 0, 2] = torch.where(det < 0, -1.0, 1.0).to(U.dtype)
    R = (U * sign) @ Vh
    return R.transpose(-1, -2)                                 # row k = R[:, k]
