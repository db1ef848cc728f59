"""The full-order projective-dynamics recording the bases are made from.

A plain rewrite, in float64 on the host, of ``Solver`` with
``global_solve="host"`` of ``animsnapbases_tpu_torch/sim/solver.py`` at
commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3 (the reference's
``Simulators.py`` ``Solver``): the damped predictor s = q + dt eta v +
dt^2 f / m, the floor clamp of its y row, ``iterations`` local-global
sweeps (every group's projections, b = M / dt^2 s + sum S^T p, one sparse
LU solve a dimension), v = (q' - q) / dt.  It keeps each frame's positions
and each group's projections of the frame's last sweep, as the program's
recorder writes them to ``<group>_p.npz``.  Changed: one LU of a
dimension's (N, N) block in place of the (3N, 3N) matrix (the blocks are
equal), and the projections of each group's kind file.

A pin schedule (``recording.events``: ``{"frame", "action": "fix" |
"release", "set"}``, ``set`` one of the scene's side sets) pins or frees
its set before the frame's step and factors the global matrix anew, as
``demos/scenarios.py`` ``ScenarioDriver.run`` does with its
``set_dirty()`` after each fix or release.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg
import torch

from portbench.reference.scene import (FLOOR_HEIGHT, Scene, global_block,
                                       pin_masses)

ACTIONS = ("fix", "release")


def tensor_data(data: dict, device, dtype) -> dict:
    """A group's rest data with its float arrays as ``dtype`` tensors and
    its bool arrays (masks) as tensors, on ``device``."""
    out = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            out[k] = torch.as_tensor(v, dtype=dtype, device=device)
        elif isinstance(v, np.ndarray) and v.dtype.kind == "b":
            out[k] = torch.as_tensor(v, device=device)
        else:
            out[k] = v
    return out


def schedule(scene: Scene, events) -> dict:
    """{frame: [(vertex ids, pinned after)]} of a pin schedule."""
    out = {}
    for e in events:
        if e["action"] not in ACTIONS or e["set"] not in scene.sets:
            raise ValueError(f"portbench: bad pin event {e!r} (actions "
                             f"{ACTIONS}, sets {sorted(scene.sets)})")
        out.setdefault(int(e["frame"]), []).append(
            (scene.sets[e["set"]], e["action"] == "fix"))
    return out


def record(scene: Scene, frames: int, iterations: int, dt: float,
           damping: float, fext: np.ndarray, events=()):
    """``frames`` steps from the scene's initial state at rest under
    ``fext``, with the pin schedule ``events`` -> (trajectory (frames, N,
    3), {group: (frames, e * p, 3) projections of each frame's last
    sweep})."""
    eta = 1.0 - damping
    pinned = scene.pinned.copy()
    plan = schedule(scene, events)

    def factor():
        m = pin_masses(scene.mass, pinned)
        lu = scipy.sparse.linalg.splu(global_block(scene, dt, m))
        return lu, (m / (dt * dt))[:, None], fext / m[:, None]

    lu, mass_dt2, a = factor()
    data = {k: tensor_data(g.data, "cpu", torch.float64)
            for k, g in scene.groups.items()}
    corners = {k: torch.as_tensor(g.kind.corners(g.data))
               for k, g in scene.groups.items()}
    P = scene.positions.copy()
    V = np.zeros_like(P)
    traj = np.empty((frames,) + P.shape)
    snaps = {k: np.empty((frames, g.num * g.p, 3))
             for k, g in scene.groups.items()}
    for t in range(frames):
        if t in plan:
            for ids, pin in plan[t]:
                pinned[ids] = pin
            lu, mass_dt2, a = factor()
        sn = P + dt * eta * V + dt * dt * a
        if scene.floor:
            sn[:, 1] = np.maximum(sn[:, 1], FLOOR_HEIGHT)
        q = sn
        for _ in range(iterations):
            b = mass_dt2 * sn
            qt = torch.as_tensor(q)
            for k, g in scene.groups.items():
                p = g.kind.rows(qt[corners[k]], data[k])
                p = p.reshape(-1, 3).numpy()
                b = b + g.ST @ p
                snaps[k][t] = p
            q = lu.solve(np.ascontiguousarray(b))
        V = (q - P) / dt
        P = q
        traj[t] = P
    return traj, snaps
