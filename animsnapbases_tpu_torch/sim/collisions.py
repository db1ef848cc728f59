"""Floor collision on the host.

Counterpart of ``animsnapbases_tpu/sim/collisions.py``: only
``resolve_floor_collision``, which ``AnimSnapBasesSolver.step`` uses for
the ``positions_corrections`` bookkeeping.  The self-collision resolvers
are not ported yet (ROADMAP Queue A item 12).
"""

from __future__ import annotations

import numpy as np


def resolve_floor_collision(positions: np.ndarray, floor_height: float):
    """Clamp y to the floor; returns (new_positions, corrections) where
    corrections = -(new - old) per vertex."""
    new = positions.copy()
    below = new[:, 1] < floor_height
    new[below, 1] = floor_height
    corrections = -(new - positions)
    return new, corrections
