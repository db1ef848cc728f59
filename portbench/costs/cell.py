"""Bytes and operations a call needs, from the cell's shapes alone.

The least work of one call of ``steps`` steps of ``sims`` sims of a
hyper-reduced model (N vertices, r position modes, n_sel vertices read by
the selected rows, the rows of each kind), at the configuration's
precision, whatever route, build or bound the program takes:

* per call, each input read once and each output written once: every
  sim's positions, velocities and forces (3 x 3N values) in, positions and
  velocities (2 x 3N) out; the two (3, r, N) matrices ``U`` and ``U^T
  A_c``, shared by the sims, read once, with one projection of the
  predictor and one lift (2 x 3rN operations each, a sim); the loop's small
  operands (``Ar^-1``, the rows of ``U`` at the n_sel vertices, the rows'
  ``W``) read once;
* per sim-step, the loop: ``iterations`` x (u = Ar^-1 rb: 2 x 3r^2; the
  selected vertices lifted: 2 x 3 r n_sel; each row's projection: its
  kind's ``ROW_FLOPS``, from ``portbench/reference/kinds/<kind>.py``; rb =
  c + W p: 2 x 3 r rows) and the last solve (2 x 3r^2);
* per sim-step whose predictor the floor clamps (counted on the reference's
  own trajectory, never on the program's route or on its bound's trips):
  the y rows of both matrices read (2 r N values), the y rows of the state
  read and written (5N), and the clamp's correction projected and lifted
  (2 x 2 r N operations).

Copied at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3 from
``chip_smoke.py`` ``k1_cost``…``k3m_cost`` and ``bound_ms`` (its
``KIND_FLOPS`` are in the kind files), and reworked: those count what each
kernel of a route reads (kernel 5's chunks and the exact checks its floor
bound sent it to, kernel 3's rebases); this counts what a step of the model
needs, so that a change of route or bound does not change the yardstick.
Operations are float32, the configurations' precision.
"""

from __future__ import annotations

import json
from pathlib import Path

from portbench.reference.scene import kind_module

STATE_BYTES = 4
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def call_cost(shape: dict, sims: int, steps: int, contact_steps: int = 0,
              root=None):
    """(bytes, float32 operations) of one call.  ``shape``: ``n``, ``r``,
    ``n_sel``, ``rows`` ({kind: count}), ``iterations``, ``matrix_bytes``
    (the storage size of an entry of the big matrices); ``contact_steps``
    the sim-steps of the call whose predictor the floor clamps.  Each
    kind's row operations come from its kind file in the checkout at
    ``root``: a kind without one raises an error, never counts as 0."""
    n, r, n_sel = shape["n"], shape["r"], shape["n_sel"]
    rows = shape["rows"]
    m = sum(rows.values())
    it = shape["iterations"]
    mb = shape["matrix_bytes"]
    small = STATE_BYTES * (3 * r * r + 3 * n_sel * r + 3 * r * m
                           + 12 * m)
    nbytes = (STATE_BYTES * sims * 15 * n + mb * 2 * 3 * r * n + small
              + contact_steps * (mb * 2 * r * n + STATE_BYTES * 5 * n))
    step = (it * (2 * 3 * r * r + 2 * 3 * r * n_sel
                  + sum(int(kind_module(k, root).ROW_FLOPS) * c
                        for k, c in rows.items())
                  + 2 * 3 * r * m) + 2 * 3 * r * r)
    ops = (sims * steps * step + sims * 2 * 2 * 3 * r * n
           + contact_steps * 2 * 2 * r * n)
    return nbytes, ops


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds of a call on the card: the larger of its bytes at
    the memory rate and its operations at the float32 rate."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["flops_per_s"]["float32"])
