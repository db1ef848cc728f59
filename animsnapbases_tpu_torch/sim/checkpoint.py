"""Simulator checkpoint and resume.

Counterpart of ``animsnapbases_tpu/sim/checkpoint.py``, with the same npz
keys, so that a checkpoint of either package loads into the other: the
model's positions, velocities, masses and fixed flags and the solver's
frame counter.  Masses and fixed flags set the global matrix, so a
resumed solver prepares again.
"""

from __future__ import annotations

import numpy as np


def save_sim_state(path: str, solver) -> None:
    model = solver.model
    np.savez(
        path,
        positions=model.positions,
        velocities=model.velocities,
        mass=model.mass,
        fixed_flags=model.fixed_flags,
        frame=np.asarray(solver.frame),
    )


def load_sim_state(path: str, solver) -> None:
    """Restore the state into the solver's model and mark the solver dirty
    (the global matrix depends on the masses and fixed flags and is
    prepared again before the next step)."""
    data = np.load(path)
    model = solver.model
    model.positions = data["positions"].copy()
    model.velocities = data["velocities"].copy()
    model.mass = data["mass"].copy()
    model.fixed_flags = data["fixed_flags"].copy()
    solver.frame = int(data["frame"])
    solver.set_dirty()
