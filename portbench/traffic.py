"""The one generator of every traffic mix (``portbench/traffic/<mix>.json``).

A mix is a closed loop of one client: request i is one call of the entry
(``run_steps`` of one sim, or ``make_batched_run`` of ``sims`` sims) of
``steps`` steps, each sim starting from its own seeded state:

* ``start``: ``rest`` (the scene's initial, hanging state) or
  ``floor_gap`` (the initial state moved down until its lowest vertex sits
  ``gap`` above the floor, every vertex falling at ``speed``);
* ``velocity``: ``tail`` (``factor`` x ``scale`` x the recording's last
  velocity, zero at the pins) or ``none``;
* ``force``: ``gravity`` or ``none``.

Every seeded parameter is drawn from its range by stratified sampling:
sims are numbered k = i * sims + j, and each block of ``strata``
consecutive sims holds one draw in each of the ``strata`` equal parts of
the range, in an order and at offsets drawn from the seed (one generator a
block and parameter).  So every seed serves the same mix of sizes, in
another order, and two seeds do the same work to within a stratum.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

from portbench.reference.scene import FLOOR_HEIGHT

RANGES = ("scale", "gap", "speed")


def load(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "portbench" / "traffic"
                       / f"{name}.json").read_text())


def host_mul(a, b, out):
    """``out[...] = a * b``: on torch's threads where ``out`` is a
    batch's tens of megabytes, in numpy where it is small (a parallel
    region costs more than it saves there)."""
    if out.size < 1 << 20:
        np.multiply(a, b, out=out)
    else:
        torch.mul(torch.from_numpy(np.asarray(a)), torch.from_numpy(b),
                  out=torch.from_numpy(out))


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = int(seed) % 2 ** 64
        self.steps = int(spec["steps"])
        self.sims = int(spec["sims"])
        self.strata = int(spec["strata"])
        self.batched = spec["entry"] == "make_batched_run"

    def units(self, i: int, param: str) -> np.ndarray:
        """The stratified draws in [0, 1) of request i's sims."""
        k = i * self.sims + np.arange(self.sims)
        block, pos = np.divmod(k, self.strata)
        out = np.empty(self.sims)
        for b in np.unique(block):
            perm, jitter = self._block(int(b), RANGES.index(param))
            at = block == b
            out[at] = (perm[pos[at]] + jitter[pos[at]]) / self.strata
        return out

    @functools.lru_cache(maxsize=len(RANGES))
    def _block(self, block: int, param: int):
        """The order and offsets of one block's strata: one generator a
        block and parameter, kept while the block's requests are made."""
        rng = np.random.default_rng([self.seed, block, param])
        return rng.permutation(self.strata), rng.random(self.strata)

    def params(self, i: int) -> dict:
        """The seeded parameters of request i: name -> (sims,) array."""
        v, s = self.spec["velocity"], self.spec["start"]
        ranges = {}
        if v["kind"] == "tail":
            ranges["scale"] = v["scale"]
        if s["kind"] == "floor_gap":
            ranges.update(gap=s["gap"], speed=s["speed"])
        return {name: lo + (hi - lo) * self.units(i, name)
                for name, (lo, hi) in ranges.items()}


class Requests:
    """Request i's inputs (P0, V0, F): host float64, (N, 3) for one sim or
    (sims, N, 3).  They are written into arrays of the generator's own,
    made once, so that making a request costs one pass over the
    velocities (and the positions, where the start is drawn); a request's
    arrays are overwritten by the next, so a caller that keeps them
    copies them."""

    def __init__(self, traffic: Traffic, positions, mass, tail):
        self.t = traffic
        shape = (traffic.sims,) + positions.shape
        self.positions = positions
        self.tail = tail
        self.P = np.ascontiguousarray(np.broadcast_to(positions, shape))
        self.V = np.zeros(shape)
        self.F = np.zeros(shape)
        if traffic.spec["force"] == "gravity":
            self.F[..., 1] = -9.81 * mass
        self.lowest = float(positions[:, 1].min())

    def __call__(self, i: int):
        t, spec = self.t, self.t.spec
        p = t.params(i)
        if spec["start"]["kind"] == "floor_gap":
            self.P[:] = self.positions
            self.P[..., 1] += (FLOOR_HEIGHT + p["gap"] - self.lowest)[:, None]
        if spec["velocity"]["kind"] == "tail":
            coef = float(spec["velocity"]["factor"]) * p["scale"]
            host_mul(coef[:, None, None], self.tail, self.V)
        if spec["start"]["kind"] == "floor_gap":
            if spec["velocity"]["kind"] != "tail":
                self.V[:] = 0.0
            self.V[..., 1] -= p["speed"][:, None]
        if t.batched:
            return self.P, self.V, self.F
        return self.P[0], self.V[0], self.F[0]
