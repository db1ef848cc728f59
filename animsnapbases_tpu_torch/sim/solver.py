"""Global-matrix assembly shared by the solvers.

Counterpart of ``animsnapbases_tpu/sim/solver.py`` for what the reduced
solver's ``prepare`` needs: ``build_global_matrix`` and the
``flatten``/``unflatten`` layout helpers.  The full-order ``Solver`` is
not ported yet (ROADMAP Queue A item 7).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse


def flatten(p: np.ndarray) -> np.ndarray:
    return p.reshape(-1)


def unflatten(q: np.ndarray) -> np.ndarray:
    return q.reshape(-1, 3)


def build_global_matrix(model, dt: float):
    """(mass/dt^2) I + sum of group LHS triplets, as scipy CSC (3N, 3N)."""
    n = model.n_verts
    rows = [np.arange(3 * n)]
    cols = [np.arange(3 * n)]
    vals = [np.repeat(model.mass, 3) / (dt * dt)]
    for g in model.groups.values():
        rows.append(g.lhs_rows)
        cols.append(g.lhs_cols)
        vals.append(g.lhs_vals)
    return scipy.sparse.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * n, 3 * n))
