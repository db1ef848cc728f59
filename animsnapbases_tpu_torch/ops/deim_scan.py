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


def deim_rows(bases, K: int | None = None, device=None):
    """Greedy row selection on ``bases`` (ep, K_b, d) on ``device``
    (default: the card), in float64 -> (Pt (K,), residual norms (K,)) as
    tensors: the row picked for each mode, in order.  ``K`` defaults to the
    number of modes."""
    bases = torch.as_tensor(bases, dtype=PIPELINE_DTYPE,
                            device=resolve_device(device))
    ep, K_b, d = bases.shape
    K = K_b if K is None else min(K, K_b)
    basesT = bases[:, :K, :].permute(2, 0, 1).contiguous()   # (d, ep, K)
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
        rsq = (r ** 2).sum(dim=0)                            # (ep,)
        idx = torch.argmax(rsq)
        Pt[k] = idx
        res[k] = torch.sqrt(rsq[idx])
        new_row = basesT[:, idx, :]                          # (d, K)
        Vsel[:, k, :] = new_row
        Minv = _border_update(Minv, b, torch.where(mask, new_row, 0.0),
                              new_row[:, k:k + 1], k, K)
    return Pt, res


def deim_rows_host_result(bases, p: int, K: int | None = None, device=None):
    """:func:`deim_rows` as numpy (Pt, alphas, alpha_ranges) in the
    reference's output convention."""
    Pt, _ = deim_rows(bases, K, device=device)
    Pt = Pt.cpu().numpy().astype(np.int64)
    return Pt, Pt // p, np.arange(1, len(Pt) + 1)


def deim_blocks(bases, p: int, K: int | None = None, device=None):
    """Greedy block selection (block DEIM) on ``bases`` (ep, K_b * p, d) on
    ``device`` (default: the card), in float64 -> alphas (K,), the element
    picked for each block of p modes, as a tensor.  At step k the residual
    of modes [k p, (k + 1) p) against the selected (k p, k p) system picks
    the row of largest residual energy; all p rows of its element join the
    selection.  ``K`` defaults to the number of blocks."""
    bases = torch.as_tensor(bases, dtype=PIPELINE_DTYPE,
                            device=resolve_device(device))
    ep, kp_total, d = bases.shape
    K = kp_total // p if K is None else min(K, kp_total // p)
    Kp = K * p
    basesT = bases[:, :Kp, :].permute(2, 0, 1).contiguous()  # (d, ep, Kp)
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
        alpha = torch.argmax((r ** 2).sum(dim=(0, 2))) // p
        alphas[k] = alpha
        newV = basesT[:, alpha * p + offsets, :]              # (d, p, Kp)
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
                            device=None):
    """:func:`deim_blocks` as numpy (Pt, alphas, alpha_ranges) in the
    reference's output convention (Pt holds whole p-row blocks)."""
    alphas = deim_blocks(bases, p, K, device=device).cpu().numpy().astype(
        np.int64)
    Pt = (alphas[:, None] * p + np.arange(p)[None, :]).reshape(-1)
    return Pt, alphas, np.arange(1, len(alphas) + 1)
