"""``tris_strain``: each triangle's 2-D deformation gradient, its singular
values clamped.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3,
of ``animsnapbases_tpu_torch/sim/groups.py`` ``build_tris_strain``
(reduced to the rest data the projection reads, S^T and the block) and of
``sim/projections.py`` ``tris_strain_p`` (itself the reference's
``Constraint_projections.py``), rewritten on ``torch.linalg.svd`` in place
of the program's Jacobi routines: F = P^T Ds DmInv (2x2), its singular
values clamped to [sigma_min, sigma_max]; the projection's rows are the
columns of P Fhat (3 x 2), row k of an element being column k.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.scene import coo

p = 2
# the 2x2 clamp with its two half-angle steps: csrc/iteration.cuh:192-217
# (KIND_TRI) and :100 clamped_fhat_2x2, counted in chip_smoke.py:300-310
ROW_FLOPS = 110
PROGRAM = {"method": "add_tri_constrain_strain",
           "kwargs": ["sigma_min", "sigma_max", "wi"],
           "group": "tris_strain"}


def build(V, F, T, group):
    faces = np.asarray(F, dtype=np.int64)
    wi = group["wi"]
    e, n = len(faces), len(V)
    p1, p2, p3 = (V[faces[:, k]] for k in range(3))
    e1, e2 = p2 - p1, p3 - p1
    b0 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    b1 = e2 - (e2 * b0).sum(axis=1, keepdims=True) * b0
    b1 = b1 / np.linalg.norm(b1, axis=1, keepdims=True)
    P = np.stack([b0, b1], axis=2)                              # (e, 3, 2)
    rest2d = np.einsum("eij,eik->ejk", P, np.stack([e1, e2], axis=2))
    DmInv = np.linalg.inv(rest2d)
    scale = wi * np.abs(0.5 * np.linalg.det(rest2d))
    B = np.empty((e, 3, 2))
    B[:, 1], B[:, 2] = DmInv[:, 0], DmInv[:, 1]
    B[:, 0] = -(DmInv[:, 0] + DmInv[:, 1])
    st = [(faces[:, j], np.arange(e) * 2 + c, B[:, j, c] * scale)
          for j in range(3) for c in range(2)]
    K = np.einsum("eac,ebc->eab", B, B) * scale[:, None, None]
    blk = [(faces[:, a], faces[:, b], K[:, a, b])
           for a in range(3) for b in range(3)]
    data = {"faces": faces, "P": P, "DmInv": DmInv,
            "sigma_min": float(group["sigma_min"]),
            "sigma_max": float(group["sigma_max"])}
    return data, coo(*zip(*st), (n, 2 * e)), coo(*zip(*blk), (n, n))


def corners(data):
    return data["faces"]


def rows(corners, data):
    Ds = torch.stack([corners[..., 1, :] - corners[..., 0, :],
                      corners[..., 2, :] - corners[..., 0, :]], dim=-1)
    P = data["P"]
    F = P.transpose(-1, -2) @ Ds @ data["DmInv"]               # (..., 2, 2)
    U, s, Vh = torch.linalg.svd(F)
    s = s.clamp(min=data["sigma_min"], max=data["sigma_max"])
    Fhat = (U * s[..., None, :]) @ Vh
    return (P @ Fhat).transpose(-1, -2)                        # (..., 2, 3)
