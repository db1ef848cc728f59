"""Greedy deflation extraction of the position bases.

Counterpart of ``animsnapbases_tpu/bases/greedy.py``: each step picks the
vertex of largest residual energy, takes the dominant mode of its (3, F)
trajectory (``ops/svd3.py`` ``top_mode_rows``) and deflates the rank-1
term from the whole (F, N, 3) residual.  :func:`extract_global` runs the
K steps on the residual's device with no host sync inside a step (the
JAX package's ``lax.scan``); local support and SPLOCS loop on the host
around :func:`select_vertex`, :func:`dominant_mode` and :func:`deflate`,
to query a geodesic support map per pick.  ``project_weight`` and
``signed_nonneg_weight`` also give the weights of the greedy block
deflation in ``bases/constraints.py``.
"""

from __future__ import annotations

import torch

from animsnapbases_tpu_torch.ops.svd3 import top_mode_rows


def project_weight(x: torch.Tensor) -> torch.Tensor:
    """Non-negative cone projection, normalized to max 1."""
    x = torch.clamp(x, min=0.0)
    mx = x.max()
    return torch.where(mx == 0, x, x / torch.where(mx == 0, 1.0, mx))


def signed_nonneg_weight(wk: torch.Tensor) -> torch.Tensor:
    """The larger (in norm) of the projections of +wk and -wk onto the
    non-negative cone."""
    wp = project_weight(wk)
    wn = project_weight(-wk)
    return torch.where(torch.linalg.vector_norm(wp)
                       > torch.linalg.vector_norm(wn), wp, wn)


def select_vertex(R: torch.Tensor) -> torch.Tensor:
    """Vertex index (a 0-dim tensor on R's device) with maximal summed
    squared residual over frames and dimensions."""
    return torch.argmax((R ** 2).sum(dim=(0, 2)))


def dominant_mode(R: torch.Tensor, idx):
    """(sigma0, wk) of the (3, F) trajectory of vertex ``idx`` (an int or a
    0-dim tensor); wk is sigma0 times the first right singular vector."""
    idx = torch.as_tensor(idx, device=R.device).reshape(1)
    return top_mode_rows(R.index_select(1, idx)[:, 0, :].T)


def deflate(R: torch.Tensor, wk: torch.Tensor, support=None):
    """The optimal component under the support map and the residual with
    its rank-1 term removed:  ck = (wk . R) * support / <wk, wk>;
    R' = R - wk (x) ck -> (ck (N, 3), R').  ``support=None`` is the global
    support (all ones)."""
    ck = torch.einsum("f,fnd->nd", wk, R)
    if support is not None:
        ck = ck * support[:, None]
    ck = ck / (wk @ wk)
    return ck, R - wk[:, None, None] * ck[None]


def extract_global(R0: torch.Tensor, num_components: int, mesh=None):
    """Full greedy extraction with global support on R0's device.

    Returns (comps (K, N, 3), weights (F, K), sigma0s (K,), res_norms (K,),
    indices (K,), R_final), all tensors on R0's device; the K steps queue
    their work without reading anything back.  ``mesh`` (a sharded vertex
    axis in the JAX package) raises ``NotImplementedError`` naming ROADMAP
    Queue A item A18."""
    if mesh is not None:
        raise NotImplementedError(
            "extract_global(mesh=...): the sharded bases compute is not "
            "ported to PyTorch yet (ROADMAP Queue A item A18)")
    R = R0
    C, W, sig, res, idxs = [], [], [], [], []
    for _ in range(num_components):
        idx = select_vertex(R)
        sigma0, wk = dominant_mode(R, idx)
        ck, R = deflate(R, wk)
        C.append(ck)
        W.append(wk)
        sig.append(sigma0)
        res.append(torch.linalg.vector_norm(R))
        idxs.append(idx)
    return (torch.stack(C), torch.stack(W, dim=1), torch.stack(sig),
            torch.stack(res), torch.stack(idxs), R)
