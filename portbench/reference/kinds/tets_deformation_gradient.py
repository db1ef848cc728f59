"""``tets_deformation_gradient``: each tet's deformation gradient projected
to its rotation.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3,
of ``animsnapbases_tpu_torch/sim/groups.py`` ``_tet_group`` (reduced to
DmInv, S^T and the block) and ``sim/projections.py``
``tets_deformation_gradient_p``, rewritten on ``torch.linalg.svd`` in place
of the program's Jacobi routines: F = Ds DmInv (3x3), R = U V^T with U's
last column negated where det(U V^T) < 0; row k of an element is R[:, k].
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.scene import coo

p = 3
# the tet row with its five Jacobi sweeps: csrc/iteration.cuh:148
# project_tet and csrc/strain3d.cuh:143 tet_projection, counted in
# chip_smoke.py:300-312
ROW_FLOPS = 1120
PROGRAM = {"method": "add_tet_constrain_deformation_gradient",
           "kwargs": ["wi"], "group": "tets_deformation_gradient"}


def build(V, F, T, group):
    tets = np.asarray(T, dtype=np.int64)
    wi = group["wi"]
    e, n = len(tets), len(V)
    q = V[tets]
    Dm = np.stack([q[:, 0] - q[:, 3], q[:, 1] - q[:, 3], q[:, 2] - q[:, 3]],
                  axis=2)
    DmInv = np.linalg.inv(Dm)
    scale = wi * np.abs(np.linalg.det(Dm) / 6.0)
    G = np.concatenate([DmInv, -DmInv.sum(axis=1, keepdims=True)], axis=1)
    st = [(tets[:, j], np.arange(e) * 3 + c, G[:, j, c] * scale)
          for j in range(4) for c in range(3)]
    K = np.einsum("eic,ejc->eij", G, G) * scale[:, None, None]
    blk = [(tets[:, a], tets[:, b], K[:, a, b])
           for a in range(4) for b in range(4)]
    return ({"elements": tets, "DmInv": DmInv},
            coo(*zip(*st), (n, 3 * e)), coo(*zip(*blk), (n, n)))


def corners(data):
    return data["elements"]


def rows(corners, data):
    c4 = corners[..., 3, :]
    Ds = torch.stack([corners[..., 0, :] - c4, corners[..., 1, :] - c4,
                      corners[..., 2, :] - c4], dim=-1)
    F = Ds @ data["DmInv"]
    U, _, Vh = torch.linalg.svd(F)
    det = torch.linalg.det(U @ Vh)
    sign = torch.ones_like(U[..., :1, :])
    sign[..., 0, 2] = torch.where(det < 0, -1.0, 1.0).to(U.dtype)
    R = (U * sign) @ Vh
    return R.transpose(-1, -2)                                 # row k = R[:, k]
