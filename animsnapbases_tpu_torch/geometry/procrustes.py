"""Rigid or translation-only frame alignment by the orthogonal Procrustes
problem.

Counterpart of ``animsnapbases_tpu/geometry/procrustes.py``: every frame of
an (F, N, 3) animation is aligned onto frame 0 at once on the device, one
batched (F, 3, 3) cross-covariance product and one batched
``torch.linalg.svd``, in float64.

JAX's rule is kept where the cross-covariance m = (to - t1)^T (from - t0)
has full rank: r = u @ vt, the whole of r negated when det(r) < 0, and the
translation t1 - r @ t0, in the translation-only ``_centered`` mode too.
Where m has rank 2 (its smallest singular value below
``RANK2_RTOL`` of its largest; every frame when frame 0 is planar, as a
procedural cloth at rest is), the sign of the third singular pair is not
set by m, and JAX's r follows its SVD library's sign convention.  There
the port fixes that sign so that det(u @ vt) = +1: one of the two answers
the JAX code can give, the same on the card and on the CPU (ROADMAP
Queue C).
"""

from __future__ import annotations

import numpy as np
import torch

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device

# relative size of the smallest singular value of m below which m counts
# as rank 2 and the third pair's sign is fixed
RANK2_RTOL = 1e-12


def procrustes_transforms(frompts: torch.Tensor, topts: torch.Tensor):
    """The Procrustes rotation and translation moving each frame of
    ``frompts`` (F, N, 3) onto ``topts`` (N, 3) -> (R (F, 3, 3), t (F, 3),
    the singular values of each frame's m (F, 3)): the rigid transform is
    ``x @ R^T + t``, the translation-only one ``x + t`` (the same t)."""
    t0 = frompts.mean(dim=1)                            # (F, 3)
    t1 = topts.mean(dim=0)                              # (3,)
    m = (topts - t1).T @ (frompts - t0[:, None, :])     # (F, 3, 3)
    u, s, vt = torch.linalg.svd(m)
    rank2 = s[:, 2] < RANK2_RTOL * s[:, 0]
    # rank 2: the third pair's sign chosen so that det(u @ vt) = +1
    flip = rank2 & (torch.linalg.det(u) * torch.linalg.det(vt) < 0)
    sign = torch.ones_like(s)
    sign[:, 2] = torch.where(flip, -1.0, 1.0)
    r = (u * sign[:, None, :]) @ vt
    r = torch.where((torch.linalg.det(r) < 0)[:, None, None], -r, r)
    t = t1 - (r @ t0[:, :, None])[:, :, 0]
    return r, t, s


def rigid_procrustes(frompts: torch.Tensor, topts: torch.Tensor,
                     rigid: bool = True) -> torch.Tensor:
    """The 4x4 transform moving one frame ``frompts`` (N, 3) onto ``topts``
    (N, 3), on their device in their dtype: the rotation of
    :func:`procrustes_transforms` (the rank-2 rule included) and its
    translation; ``rigid=False`` keeps the identity rotation with that
    translation, as the JAX function does."""
    r, t, _ = procrustes_transforms(frompts[None], topts)
    T = torch.eye(4, dtype=frompts.dtype, device=frompts.device)
    if rigid:
        T[:3, :3] = r[0]
    T[:3, 3] = t[0]
    return T


def align_frames(verts: torch.Tensor, rigid: bool = True) -> torch.Tensor:
    """Every frame of ``verts`` (F, N, 3) aligned onto frame 0, in the
    tensor's dtype on its device."""
    r, t, _ = procrustes_transforms(verts, verts[0])
    if rigid:
        return verts @ r.transpose(1, 2) + t[:, None, :]
    return verts + t[:, None, :]


def align_animation(verts: np.ndarray, rigid: bool = True,
                    device=None) -> np.ndarray:
    """Align every frame of (F, N, 3) onto frame 0 on ``device`` in float64
    (``rigid=False``: the translation only, the '_centered' mode) -> float32
    on the host, as the JAX package returns it."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.asarray(verts), dtype=PIPELINE_DTYPE, device=dev)
    return align_frames(v, rigid).cpu().numpy().astype(np.float32)
