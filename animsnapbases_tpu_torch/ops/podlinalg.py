"""Snapshot-POD linear algebra (the method of snapshots).

Counterpart of ``animsnapbases_tpu/ops/podlinalg.py``.  For a snapshot
matrix X (n, F) with n >> F the left singular vectors come from the F x F
Gram matrix: X^T X = W L W^T, U = X W L^{-1/2}.  :func:`snapshot_pod` does
this on the port's device in float64 (``device.PIPELINE_DTYPE``),
:func:`snapshot_pod_host` with numpy and BLAS on the host; both zero-fill
the columns of U past the numerical rank.  :func:`snapshot_pod_sharded`
splits the rows of X over a mesh axis: the Gram matrix is one
``all_reduce`` of the blocks' X_s^T X_s, the F x F eigendecomposition runs
replicated, and each rank lifts its block of U, which is gathered on every
rank (``parallel/collectives.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device


def snapshot_pod(X, device=None):
    """Economy SVD of X (n, F), n >= F, via the Gram matrix, on ``device``
    (default: the card) -> (U (n, F), s (F,), Vt (F, F)) as float64
    tensors, singular values descending; the columns of U whose singular
    value is below 1e-12 of the largest are zero."""
    X = torch.as_tensor(X, dtype=PIPELINE_DTYPE,
                        device=resolve_device(device))
    w, W = torch.linalg.eigh(X.T @ X)                  # ascending
    w, W = w.flip(0), W.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    denom = torch.where(s > 1e-12 * (s[0] + 1e-30), s, torch.inf)
    return (X @ W) / denom[None, :], s, W.T


def snapshot_pod_host(X, n_modes: int | None = None):
    """Host (numpy float64) twin of :func:`snapshot_pod`: the same Gram
    method (one ``dsyrk``) and zero-fill; ``n_modes`` keeps the leading
    columns of U only, the singular values are all returned."""
    from scipy.linalg import blas

    X = np.asarray(X, dtype=np.float64)
    F = X.shape[1]
    k = F if n_modes is None else min(int(n_modes), F)
    Xf = X if X.flags.c_contiguous or X.flags.f_contiguous else (
        np.ascontiguousarray(X))
    G = blas.dsyrk(1.0, Xf, trans=1, lower=0)       # upper triangle of X^T X
    G = np.triu(G) + np.triu(G, 1).T
    w, W = np.linalg.eigh(G)
    w = w[::-1]
    W = np.ascontiguousarray(W[:, ::-1])
    s = np.sqrt(np.maximum(w, 0.0))
    denom = np.where(s > 1e-12 * (s[0] + 1e-30), s, np.inf)
    U = Xf @ (W[:, :k] / denom[None, :k])
    return U, s, W.T


def snapshot_pod_sharded(X, mesh, axis: str = "model", device=None):
    """:func:`snapshot_pod` with the rows of X (n, F), given whole on every
    rank, split over ``mesh[axis]`` on ``device`` (default the card) -> the
    same (U, s, Vt), replicated, in float64.  The Gram matrix sums the
    ranks' partial products in another order than one product does, so the
    two agree to the Gram method's rounding, not bit for bit."""
    from animsnapbases_tpu_torch.parallel.collectives import (
        all_reduce_sum,
        axis_of,
        block_range,
        gather_blocks,
    )

    group, size, index = axis_of(mesh, axis)
    X = torch.as_tensor(X, dtype=PIPELINE_DTYPE,
                        device=resolve_device(device))
    lo, hi = block_range(X.shape[0], size, index)
    Xs = X[lo:hi]
    w, W = torch.linalg.eigh(all_reduce_sum(Xs.T @ Xs, group))
    w, W = w.flip(0), W.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    denom = torch.where(s > 1e-12 * (s[0] + 1e-30), s, torch.inf)
    U = gather_blocks((Xs @ W) / denom[None, :], X.shape[0], mesh, axis)
    return U, s, W.T
