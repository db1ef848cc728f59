"""Numerical invariant checks of the bases pipeline, each returning values
so tests can assert.

Copy of ``animsnapbases_tpu/utils/checks.py`` (numpy only): the checks
``bases/constraints.py`` uses, :func:`is_sparse` and the reference's gate on
a matrix, :func:`check_matrix_properties`.
"""

from __future__ import annotations

import numpy as np


def sparsity_fractions(tensor: np.ndarray) -> np.ndarray:
    """Fraction of zero entries per trailing dim of a (:, :, 3) tensor."""
    t = np.asarray(tensor)
    assert t.shape[2] == 3
    return np.array([1.0 - np.count_nonzero(t[:, :, l]) / t[:, :, l].size
                     for l in range(3)])


def is_sparse(tensor: np.ndarray, threshold: float = 0.5) -> bool:
    """Whether every trailing dim is more than ``threshold`` zeros."""
    return bool(sparsity_fractions(tensor).min() > threshold)


def ranks_per_dim(tensor: np.ndarray) -> list[int]:
    t = np.asarray(tensor)
    return [int(np.linalg.matrix_rank(t[:, :, j])) for j in range(t.shape[2])]


def is_linear_independent(tensor: np.ndarray, expected_rank: int) -> bool:
    return all(r == expected_rank for r in ranks_per_dim(tensor))


def utmu_orthogonality_error(comps: np.ndarray, mass: np.ndarray) -> float:
    """max |U^T M U - I| over the three dims; comps (K, N, 3), mass (N,)."""
    comps = np.asarray(comps)
    err = 0.0
    for l in range(comps.shape[2]):
        Mu = comps[:, :, l].T * mass[:, None]
        utmu = comps[:, :, l] @ Mu
        err = max(err, float(np.abs(utmu - np.eye(comps.shape[0])).max()))
    return err


def check_matrix_properties(A: np.ndarray, cond_limit: float = 1e12) -> dict:
    """Square, determinant, condition, rank and symmetry of ``A`` as a
    dict; raises ``ValueError`` where the reference's gate fails."""
    A = np.asarray(A)
    rows, cols = A.shape
    if rows != cols:
        raise ValueError("Matrix is not square.")
    det = np.linalg.det(A)
    if np.isclose(det, 0.0):
        raise ValueError("Matrix is singular (determinant is 0).")
    cond = np.linalg.cond(A)
    if cond > cond_limit:
        raise ValueError(f"Matrix has a high condition number ({cond}).")
    rank = np.linalg.matrix_rank(A)
    if rank != rows:
        raise ValueError("Matrix is rank-deficient.")
    sv = np.linalg.svd(A, compute_uv=False)
    if sv.max() / sv.min() > cond_limit:
        raise ValueError("Matrix has a wide range of singular values.")
    return {
        "det": float(det),
        "cond": float(cond),
        "rank": int(rank),
        "symmetric": bool(np.allclose(A, A.T)),
        "sigma_max": float(sv.max()),
        "sigma_min": float(sv.min()),
    }
