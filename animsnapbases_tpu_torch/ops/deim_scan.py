"""Row-wise and block DEIM as one loop on the device.

Counterpart of ``animsnapbases_tpu/ops/deim_scan.py`` (``deim_rows`` and
``deim_blocks``): the greedy DEIM recurrence, sequential in k, with the
basis kept on the device
in dimension-major layout (d, ep, K) and the inverse of the selected-row
system grown by one row and column a step with the block-bordering
identity

    [[A, b], [c^T, e]]^-1 = [[A^-1 + A^-1 b S^-1 c^T A^-1, -A^-1 b S^-1],
                             [-S^-1 c^T A^-1,               S^-1]],
    S = e - c^T A^-1 b,

embedded in a fixed (K, K) matrix whose unselected rows and columns stay
identity.  The picks stay on the device until the end: no step waits for
the host.  The block form grows the system by p rows and columns a step,
with p such updates.

With ``mesh=`` (a ``DeviceMesh`` with a "model" axis) the basis rows are
split over the axis in blocks (whole elements in the block form): each
rank computes its rows' residuals, and a step's argmax and the winning
rows are one ``all_reduce`` (``parallel/collectives.py::argmax_pick``).
Zero padding never wins an argmax, and ties go to the lowest row, so the
picks are those of one device.
"""

from __future__ import annotations

import numpy as np
import torch

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device


def _border_update(Minv, b_vec, c_vec, e_val, q, K):
    """Grow the embedded inverse Minv (d, K, K) by selection ``q``: the new
    column ``b_vec`` and row ``c_vec`` (d, K), masked to entries < q, and
    the corner ``e_val`` (d, 1)."""
    Ainv_b = torch.einsum("dab,db->da", Minv, b_vec)
    cAinv = torch.einsum("da,dab->db", c_vec, Minv)
    Sinv = 1.0 / (e_val - (cAinv * b_vec).sum(dim=1, keepdim=True))
    Minv = Minv + (Ainv_b * Sinv)[:, :, None] * cAinv[:, None, :]
    Minv = Minv.clone()
    Minv[:, :, q] = -Ainv_b * Sinv
    Minv[:, q, :] = -cAinv * Sinv
    Minv[:, q, q] = Sinv[:, 0]
    return Minv


def _row_block(bases, mesh, unit: int = 1):
    """This rank's rows of ``bases`` (ep, ...) in blocks of whole
    ``unit``-row elements -> (rows, first row); all rows without a mesh."""
    if mesh is None:
        return bases, 0
    from animsnapbases_tpu_torch.parallel.collectives import (
        axis_of,
        block_range,
    )

    _, size, index = axis_of(mesh, "model")
    lo, hi = block_range(bases.shape[0] // unit, size, index)
    return bases[lo * unit:hi * unit], lo * unit


def _pick(values, lo, payload_of, mesh):
    """The argmax of ``values`` over the split rows -> (index, value,
    payload); on one device the argmax as a tensor, which leaves the step
    waiting for nothing."""
    if mesh is None:
        i = torch.argmax(values)
        return i, values[i], payload_of(i)
    from animsnapbases_tpu_torch.parallel.collectives import argmax_pick

    return argmax_pick(values, lo, payload_of, mesh, "model")


def deim_rows(bases, K: int | None = None, device=None, mesh=None):
    """Greedy row selection on ``bases`` (ep, K_b, d) on ``device``
    (default: the card), in float64 -> (Pt (K,), residual norms (K,)) as
    tensors: the row picked for each mode, in order.  ``K`` defaults to the
    number of modes.  ``mesh`` splits the rows over its "model" axis."""
    bases = torch.as_tensor(bases, dtype=PIPELINE_DTYPE,
                            device=resolve_device(device))
    ep, K_b, d = bases.shape
    K = K_b if K is None else min(K, K_b)
    bases, lo = _row_block(bases, mesh)
    basesT = bases[:, :K, :].permute(2, 0, 1).contiguous()   # (d, ep_l, K)
    dev = basesT.device
    Pt = torch.zeros(K, dtype=torch.int64, device=dev)
    res = torch.zeros(K, dtype=basesT.dtype, device=dev)
    Vsel = torch.zeros((d, K, K), dtype=basesT.dtype, device=dev)
    Minv = torch.eye(K, dtype=basesT.dtype, device=dev).repeat(d, 1, 1)
    arange = torch.arange(K, device=dev)
    for k in range(K):
        vk = basesT[:, :, k]                                 # (d, ep)
        mask = (arange < k)[None, :]
        b = torch.where(mask, Vsel[:, :, k], 0.0)            # (d, K)
        x = torch.einsum("dab,db->da", Minv, b)
        r = vk if k == 0 else torch.einsum("dek,dk->de", basesT, x) - vk
        rsq = (r ** 2).sum(dim=0)                            # (ep_l,)
        idx, best, new_row = _pick(
            rsq, lo, lambda i: basesT[:, i, :] if i is not None
            else basesT.new_zeros((d, K)), mesh)             # (d, K)
        Pt[k] = idx
        res[k] = torch.sqrt(best)
        Vsel[:, k, :] = new_row
        Minv = _border_update(Minv, b, torch.where(mask, new_row, 0.0),
                              new_row[:, k:k + 1], k, K)
    return Pt, res


def deim_rows_host_result(bases, p: int, K: int | None = None, device=None,
                          mesh=None):
    """:func:`deim_rows` as numpy (Pt, alphas, alpha_ranges) in the
    reference's output convention."""
    Pt, _ = deim_rows(bases, K, device=device, mesh=mesh)
    Pt = Pt.cpu().numpy().astype(np.int64)
    return Pt, Pt // p, np.arange(1, len(Pt) + 1)


def deim_blocks(bases, p: int, K: int | None = None, device=None,
                mesh=None):
    """Greedy block selection (block DEIM) on ``bases`` (ep, K_b * p, d) on
    ``device`` (default: the card), in float64 -> alphas (K,), the element
    picked for each block of p modes, as a tensor.  At step k the residual
    of modes [k p, (k + 1) p) against the selected (k p, k p) system picks
    the row of largest residual energy; all p rows of its element join the
    selection.  ``K`` defaults to the number of blocks.  ``mesh`` splits
    the elements over its "model" axis."""
    bases = torch.as_tensor(bases, dtype=PIPELINE_DTYPE,
                            device=resolve_device(device))
    ep, kp_total, d = bases.shape
    K = kp_total // p if K is None else min(K, kp_total // p)
    Kp = K * p
    bases, lo = _row_block(bases, mesh, p)
    basesT = bases[:, :Kp, :].permute(2, 0, 1).contiguous()  # (d, ep_l, Kp)
    dev = basesT.device
    alphas = torch.zeros(K, dtype=torch.int64, device=dev)
    Vsel = torch.zeros((d, Kp, Kp), dtype=basesT.dtype, device=dev)
    Minv = torch.eye(Kp, dtype=basesT.dtype, device=dev).repeat(d, 1, 1)
    arange = torch.arange(Kp, device=dev)
    offsets = torch.arange(p, device=dev)
    for k in range(K):
        kp = k * p
        vk = basesT[:, :, kp:kp + p]                          # (d, ep, p)
        if k == 0:
            r = vk
        else:
            mask = (arange < kp)[None, :, None]
            b = torch.where(mask, Vsel[:, :, kp:kp + p], 0.0)  # (d, Kp, p)
            x = torch.einsum("dab,dbp->dap", Minv, b)
            r = torch.einsum("dek,dkp->dep", basesT, x) - vk
        row, _, newV = _pick(
            (r ** 2).sum(dim=(0, 2)), lo,
            lambda i: basesT[:, i // p * p + offsets, :] if i is not None
            else basesT.new_zeros((d, p, Kp)), mesh)          # (d, p, Kp)
        alpha = row // p
        alphas[k] = alpha
        Vsel[:, kp:kp + p, :] = newV
        for j in range(p):
            q = kp + j
            maskq = (arange < q)[None, :]
            Minv = _border_update(
                Minv, torch.where(maskq, Vsel[:, :, q], 0.0),
                torch.where(maskq, newV[:, j, :], 0.0), newV[:, j, q:q + 1],
                q, Kp)
    return alphas


def deim_blocks_host_result(bases, p: int, K: int | None = None,
                            device=None, mesh=None):
    """:func:`deim_blocks` as numpy (Pt, alphas, alpha_ranges) in the
    reference's output convention (Pt holds whole p-row blocks)."""
    alphas = deim_blocks(bases, p, K, device=device,
                         mesh=mesh).cpu().numpy().astype(np.int64)
    Pt = (alphas[:, None] * p + np.arange(p)[None, :]).reshape(-1)
    return Pt, alphas, np.arange(1, len(alphas) + 1)
