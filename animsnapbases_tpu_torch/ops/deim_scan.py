"""Row-wise DEIM as one loop on the device.

Counterpart of ``animsnapbases_tpu/ops/deim_scan.py`` ``deim_rows``: the
greedy DEIM recurrence, sequential in k, with the basis kept on the device
in dimension-major layout (d, ep, K) and the inverse of the selected-row
system grown by one row and column a step with the block-bordering
identity

    [[A, b], [c^T, e]]^-1 = [[A^-1 + A^-1 b S^-1 c^T A^-1, -A^-1 b S^-1],
                             [-S^-1 c^T A^-1,               S^-1]],
    S = e - c^T A^-1 b,

embedded in a fixed (K, K) matrix whose unselected rows and columns stay
identity.  The picks stay on the device until the end: no step waits for
the host.  The block form (``deim_blocks``) is not ported (ROADMAP Queue A
item A8, its block forms).
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
