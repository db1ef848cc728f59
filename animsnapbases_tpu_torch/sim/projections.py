"""Batched constraint projections of the full-order solver (its local step).

Counterpart of ``animsnapbases_tpu/sim/projections.py``: each function maps
positions q (N, 3) to the stacked projections p (e*p, 3) of one group, over
all its elements at once, with the small SVDs of ``ops/svd3.py`` (the same
Jacobi routines as the JAX package).  ``data`` holds the group's arrays as
tensors on q's device (``sim/solver.py`` ``device_group_data``).
"""

from __future__ import annotations

import torch

from animsnapbases_tpu_torch.ops.segment import coo_matvec_cols
from animsnapbases_tpu_torch.ops.svd3 import (
    floor_at,
    polar_rotation3x3,
    svd2x2,
    svd3x3,
)

_EPS = 1e-30


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: min(max(x, lo), hi), with JAX's gradient
    at a tie (:func:`floor_at`)."""
    return torch.minimum(floor_at(x, lo), torch.tensor(hi, dtype=x.dtype))


def positional_p(targets: torch.Tensor) -> torch.Tensor:
    """Positional constraints project to their targets (e, 3), computed on
    the host per frame."""
    return targets


def verts_bending_p(q: torch.Tensor, data: dict) -> torch.Tensor:
    """Mean-curvature bending projection per constrained vertex (e, 3)."""
    rest = data["rest_curvature"]
    tri_n = data["tri_normal"]
    qn = q[data["neighbors"]]                               # (e, D, 3)
    diff = (q[data["indices"]][:, None, :] - qn) * (
        data["cotans"] * data["mask"])[:, :, None]
    star_sum = diff.sum(dim=1)                               # (e, 3)
    norm = torch.linalg.vector_norm(star_sum, dim=1)
    correction = torch.where(
        (norm < 1e-10)[:, None], tri_n * rest[:, None],
        star_sum * (rest / floor_at(norm, _EPS))[:, None])
    if data.get("prevent_bending_flips", True):
        dots = (tri_n * correction).sum(dim=1)
        flip = (norm > 1e-5) & (dots * data["dot_with_normal"] < 0)
        correction = torch.where(flip[:, None], -correction, correction)
    return correction


def edge_spring_p(q: torch.Tensor, data: dict) -> torch.Tensor:
    """Spring projection: the edge's midpoint difference at rest length."""
    edges = data["edges"]
    spring = q[edges[:, 1]] - q[edges[:, 0]]
    length = torch.linalg.vector_norm(spring, dim=1)
    n = spring / floor_at(length, _EPS)[:, None]
    delta = 0.5 * (length - data["rest_length"])
    pi = 0.5 * spring - delta[:, None] * n
    return torch.where((length > 0)[:, None], pi, 0.0)


def tris_strain_p(q: torch.Tensor, data: dict) -> torch.Tensor:
    """The 2D deformation gradient's singular values clamped to [sigma_min,
    sigma_max] through the Jacobi :func:`svd2x2`; returns (e*2, 3)."""
    faces = data["faces"]
    P = data["P"]                                            # (e, 3, 2)
    q1 = q[faces[:, 0]]
    Ds = torch.stack([q[faces[:, 1]] - q1, q[faces[:, 2]] - q1], dim=2)
    F = torch.einsum("eij,eik->ejk", P, Ds) @ data["DmInv"]
    U, s, Vt = svd2x2(F)
    s = clip(s, data["sigma_min"], data["sigma_max"])
    Fhat = (U * s[:, None, :]) @ Vt                          # (e, 2, 2)
    return torch.einsum("eij,ejk->eki", P, Fhat).reshape(-1, 3)


def _tet_F(q: torch.Tensor, data: dict) -> torch.Tensor:
    el = data["elements"]
    q4 = q[el[:, 3]]
    Ds = torch.stack([q[el[:, 0]] - q4, q[el[:, 1]] - q4, q[el[:, 2]] - q4],
                     dim=2)
    return Ds @ data["DmInv"]


def tets_strain_p(q: torch.Tensor, data: dict) -> torch.Tensor:
    """The 3D deformation gradient's singular values clamped, the third
    re-signed where det F < 0; returns (e*3, 3)."""
    F = _tet_F(q, data)
    U, s, Vt = svd3x3(F)
    s = clip(s, data["sigma_min"], data["sigma_max"])
    s = torch.cat([s[:, :2], s[:, 2:] * torch.where(
        torch.linalg.det(F) < 0, -1.0, 1.0)[:, None]], dim=1)
    return ((U * s[:, None, :]) @ Vt).reshape(-1, 3)


def tets_deformation_gradient_p(q: torch.Tensor, data: dict) -> torch.Tensor:
    """The polar rotation R = U V^T; the projection is R^T, (e*3, 3)."""
    R = polar_rotation3x3(_tet_F(q, data))
    return R.transpose(1, 2).reshape(-1, 3)


# the index arrays of each group's data that hold vertex ids
VERTEX_KEYS = {
    "verts_bending": ("indices", "neighbors"),
    "edge_spring": ("edges",),
    "tris_strain": ("faces",),
    "tets_strain": ("elements",),
    "tets_deformation_gradient": ("elements",),
}

PROJECTION_KERNELS = {
    "verts_bending": verts_bending_p,
    "edge_spring": edge_spring_p,
    "tris_strain": tris_strain_p,
    "tets_strain": tets_strain_p,
    "tets_deformation_gradient": tets_deformation_gradient_p,
}


def group_rhs(st_rows, st_cols, st_vals, p_stacked, n_verts):
    """S^T @ p in a fixed order of summation (``ops/segment.py``)."""
    return coo_matvec_cols(st_rows, st_cols, st_vals, p_stacked, n_verts)
