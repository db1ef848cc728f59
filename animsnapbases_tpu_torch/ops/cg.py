"""Jacobi-preconditioned conjugate gradients for the full-order global solve.

Counterpart of ``animsnapbases_tpu/ops/cg.py``.  The global matrix couples
equal dimensions only, so it is the Kronecker lift of one SPD (N, N) block
A_d; above ``Solver.DENSE_LIMIT`` the solver runs this CG on the device on
an (N, 3) right-hand side, in displacement form (u = q - s_n, so the
pinned-mass terms cancel) and warm-started from the previous iteration's
u.  The matrix is in padded ELL form (a gather and a sum along a fixed
axis per row: no scatter, and a fixed order of summation).
:func:`make_pcg_solver` closes a solve over a matrix given as COO triplets
(:func:`coo_matvec`) or as a matvec of the caller's.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def coo_matvec(rows, cols, vals, x: torch.Tensor, n: int) -> torch.Tensor:
    """y = A x for COO triplets; x (n, k) -> y (n, k), each row summed in a
    fixed order (``ops/segment.py``)."""
    from animsnapbases_tpu_torch.ops.segment import coo_matvec_cols

    return coo_matvec_cols(rows, cols, vals, x, n)


def build_ell(rows, cols, vals, n: int, diag_add=None):
    """COO triplets coalesced into padded ELL form: ``(cols (n, k) int32,
    vals (n, k))``, padded entries pointing at row 0 with value 0;
    ``diag_add`` (n,) is added to the diagonal first."""
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    if diag_add is not None:
        A = (A + sp.diags(diag_add)).tocsr()
    counts = np.diff(A.indptr)
    k = max(int(counts.max()) if len(counts) else 1, 1)
    cols_pad = np.zeros((n, k), dtype=np.int32)
    vals_pad = np.zeros((n, k), dtype=A.data.dtype)
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    row_of = np.repeat(np.arange(n), counts)
    cols_pad[row_of, slot] = A.indices
    vals_pad[row_of, slot] = A.data
    return cols_pad, vals_pad


def ell_matvec(cols_pad: torch.Tensor, vals_pad: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A x for padded ELL; x (n, d) -> y (n, d)."""
    return (vals_pad[:, :, None] * x[cols_pad]).sum(dim=1)


def pcg_solve(matvec, dinv: torch.Tensor, rhs: torch.Tensor, x0=None,
              tol: float = 1e-12, max_iters: int = 400):
    """Jacobi-preconditioned CG on an (n, d) right-hand side -> (x,
    iterations).  ``tol`` is relative to the preconditioned norm of the
    right-hand side (a scale independent of the warm start), floored at
    50 machine epsilons of its dtype; the loop runs while any column is
    above it."""
    tiny = torch.finfo(rhs.dtype).tiny
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - matvec(x)
    z = dinv[:, None] * r
    rz = (r * z).sum(dim=0)
    rz0 = torch.clamp((rhs * (dinv[:, None] * rhs)).sum(dim=0), min=tiny)
    eff_tol = max(tol, 50.0 * float(torch.finfo(rhs.dtype).eps))
    thresh = (eff_tol * eff_tol) * rz0
    p, it = z, 0
    while it < max_iters and bool((rz > thresh).any()):
        Ap = matvec(p)
        alpha = rz / torch.clamp((p * Ap).sum(dim=0), min=tiny)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = dinv[:, None] * r
        rz_new = (r * z).sum(dim=0)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    return x, it


def make_pcg_solver(rows, cols, vals, diag, n: int, *, tol: float = 1e-12,
                    max_iters: int = 400, matvec=None):
    """``solve(rhs (n, d), x0=None, max_iterations=max_iters) -> (x,
    iterations)``: :func:`pcg_solve` on the SPD matrix given by its COO
    triplets (or by ``matvec``) and its diagonal ``diag`` (a tensor, on the
    device and in the dtype of the solves)."""
    dinv = 1.0 / diag
    if matvec is None:
        from animsnapbases_tpu_torch.ops.segment import row_layout, row_sum

        layout = row_layout(rows, cols, torch.as_tensor(
            vals, dtype=diag.dtype, device=diag.device), n)

        def matvec(x):
            return row_sum(layout, x)

    def solve(rhs, x0=None, max_iterations=max_iters):
        return pcg_solve(matvec, dinv, rhs, x0, tol=tol,
                         max_iters=max_iterations)

    return solve
