"""Sparse products in a fixed order of summation.

Counterpart of ``animsnapbases_tpu/ops/segment.py`` (``coo_matvec``,
``coo_matvec_cols``, ``segment_sum_3d``).  The
JAX package sums with ``segment_sum``; a ``torch.index_add_`` on the card
sums with atomics in no fixed order, and over the recorder's chaotic
frames a changed order of the S^T p sums can move a DEIM pick between two
runs.  Here the COO triplets are laid out once per row, padded to the
longest row (each row's entries in their COO order, the padding pointing
at row 0 with value 0), and a product gathers and sums each row along a
fixed axis: the same sums in the same order on every run.
"""

from __future__ import annotations

import torch


def row_layout(rows, cols, vals, n_rows: int):
    """(cols (n_rows, k), vals (n_rows, k)) of COO triplets, k the longest
    row (at least 1), on the device and in the dtype of ``vals``."""
    rows = torch.as_tensor(rows, device=vals.device, dtype=torch.int64)
    cols = torch.as_tensor(cols, device=vals.device, dtype=torch.int64)
    order = torch.argsort(rows, stable=True)
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = torch.bincount(rows, minlength=n_rows)
    k = max(int(counts.max()) if len(rows) else 1, 1)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(rows), device=vals.device) - start[rows]
    cols_pad = torch.zeros((n_rows, k), dtype=torch.int64, device=vals.device)
    vals_pad = torch.zeros((n_rows, k), dtype=vals.dtype, device=vals.device)
    cols_pad[rows, slot] = cols
    vals_pad[rows, slot] = vals
    return cols_pad, vals_pad


def row_sum(layout, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for A in :func:`row_layout` form and X (n_cols, d)."""
    cols_pad, vals_pad = layout
    return (vals_pad[:, :, None] * X[cols_pad]).sum(dim=1)


def coo_matvec_cols(rows, cols, vals, X: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Y = A @ X for COO A (n_rows, n_cols) and dense X (n_cols, d)."""
    vals = torch.as_tensor(vals, dtype=X.dtype, device=X.device)
    return row_sum(row_layout(rows, cols, vals, n_rows), X)


def coo_matvec(rows, cols, vals, x: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """y = A @ x for COO A (n_rows, n_cols) and a vector x (n_cols,)."""
    return coo_matvec_cols(rows, cols, vals, x[:, None], n_rows)[:, 0]


def segment_sum_3d(values: torch.Tensor, segment_ids,
                   num_segments: int) -> torch.Tensor:
    """Rows of (M, 3) ``values`` added into (num_segments, 3), each
    segment's rows in their order in ``values``."""
    m = values.shape[0]
    ones = torch.ones(m, dtype=values.dtype, device=values.device)
    return row_sum(row_layout(segment_ids, torch.arange(m), ones,
                              num_segments), values)
