"""Global-matrix assembly shared by the solvers.

Counterpart of ``animsnapbases_tpu/sim/solver.py`` for what the reduced
solver and its callers need: ``build_global_matrix``, the
``flatten``/``unflatten`` layout helpers and ``positional_targets_timeline``
(a model's target timeline, e.g. a ``targets_seq`` for
``make_batched_run``).  The full-order ``Solver`` is
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


def positional_targets_timeline(model, frame: int, num_steps: int):
    """(T, e, 3) per-frame positional-target timeline starting at ``frame``
    -> (timeline, animated).

    Frame shifts index by absolute frame and clamp at their last entry, so
    the timeline covers only the longest remaining shift: T = 1 (the
    targets at ``frame``) when nothing is animated, else min(num_steps,
    remaining).  A consumer indexes it with min(i, T - 1), which repeats
    the last row past its end.  (The JAX package pads an animated timeline
    to a power of two to reuse its compilations; the padding repeats the
    last row, so the clamped index reads the same values.)"""
    remaining = 0
    for c in getattr(model, "_positional", []):
        if (c["motion_type"] == "user_defined"
                and c["frame_shift"] is not None):
            remaining = max(remaining, len(c["frame_shift"]) - frame)
    if remaining <= 0:
        return np.asarray(model.positional_targets(frame))[None], False
    t_eff = min(num_steps, remaining)
    p0 = model.groups["positional"].data["p0"]
    tl = np.repeat(np.asarray(p0, dtype=float)[None], t_eff, axis=0)
    frames = frame + np.arange(t_eff)
    for i, c in enumerate(model._positional):
        if (c["motion_type"] == "user_defined"
                and c["frame_shift"] is not None):
            shift = c["frame_shift"]
            tl[:, i] += shift[np.minimum(frames, len(shift) - 1)]
    return tl, True
