"""Greedy deflation extraction of the position bases.

Counterpart of ``animsnapbases_tpu/bases/greedy.py``: each step picks the
vertex of largest residual energy, takes the dominant mode of its (3, F)
trajectory (``ops/svd3.py`` ``top_mode_rows``) and deflates the rank-1
term from the whole (F, N, 3) residual.  :func:`extract_global` runs the
K steps on the residual's device with no host sync inside a step (the
JAX package's ``lax.scan``), or with ``mesh=`` its vertex axis split over
the mesh's "model" axis (a step's argmax and the winning vertex's
trajectory one ``all_reduce``, ``parallel/collectives.py``); local support and SPLOCS loop on the host
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
    their work without reading anything back.  ``mesh`` (a ``DeviceMesh``
    with a "model" axis; R0 whole on every rank) splits the vertex axis:
    each rank deflates its block, the picks are those of one device (zero
    padding never wins the argmax, ties go to the lowest vertex), and the
    components and residual are gathered on every rank.  The residual
    norms sum the blocks' squares in another order, so they agree with one
    device's to rounding."""
    if mesh is not None:
        return _extract_global_sharded(R0, num_components, mesh)
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


def _extract_global_sharded(R0: torch.Tensor, num_components: int, mesh):
    from animsnapbases_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        argmax_pick,
        axis_of,
        block_range,
        gather_blocks,
    )

    group, size, index = axis_of(mesh, "model")
    F, n, _ = R0.shape
    lo, hi = block_range(n, size, index)
    R = R0[:, lo:hi]
    C, W, sig, res, idxs = [], [], [], [], []
    for _ in range(num_components):
        idx, _, traj = argmax_pick(
            (R ** 2).sum(dim=(0, 2)), lo,
            lambda i: R[:, i, :] if i is not None else R.new_zeros((F, 3)),
            mesh, "model")
        sigma0, wk = top_mode_rows(traj.T)
        ck, R = deflate(R, wk)
        C.append(gather_blocks(ck, n, mesh, "model"))
        W.append(wk)
        sig.append(sigma0)
        res.append(torch.sqrt(all_reduce_sum((R ** 2).sum(), group)))
        idxs.append(torch.as_tensor(idx, device=R.device))
    return (torch.stack(C), torch.stack(W, dim=1), torch.stack(sig),
            torch.stack(res), torch.stack(idxs),
            gather_blocks(R, n, mesh, "model", dim=1))
