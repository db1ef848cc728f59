"""Numerical invariant checks of the bases pipeline, each returning values
so tests can assert.

Copy of the checks of ``animsnapbases_tpu/utils/checks.py`` that
``bases/constraints.py`` uses (numpy only).
"""

from __future__ import annotations

import numpy as np


def sparsity_fractions(tensor: np.ndarray) -> np.ndarray:
    """Fraction of zero entries per trailing dim of a (:, :, 3) tensor."""
    t = np.asarray(tensor)
    assert t.shape[2] == 3
    return np.array([1.0 - np.count_nonzero(t[:, :, l]) / t[:, :, l].size
                     for l in range(3)])


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
