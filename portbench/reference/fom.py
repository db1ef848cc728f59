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
equal), and the projections of ``projections.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg
import torch

from portbench.reference import projections
from portbench.reference.scene import FLOOR_HEIGHT, Scene, global_block


def corner_index(scene: Scene, name: str) -> np.ndarray:
    """(e, c) vertex ids of each element's corners."""
    d = scene.groups[name].data
    return {"tris_strain": d.get("faces"), "edge_spring": d.get("edges"),
            "tets_deformation_gradient": d.get("elements")}[name]


def group_rows(name: str, corners, data: dict):
    """All rows (..., e, p, 3) of a group's projection from its corners
    (..., e, c, 3); ``data`` holds the rest data as tensors."""
    if name == "tris_strain":
        return projections.tris_strain(corners, data["P"], data["DmInv"],
                                       data["sigma_min"], data["sigma_max"])
    if name == "edge_spring":
        return projections.edge_spring(corners, data["rest_length"])
    return projections.tets_deformation_gradient(corners, data["DmInv"])


def tensor_data(data: dict, device, dtype) -> dict:
    out = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            out[k] = torch.as_tensor(v, dtype=dtype, device=device)
        else:
            out[k] = v
    return out


def record(scene: Scene, frames: int, iterations: int, dt: float,
           damping: float, fext: np.ndarray):
    """``frames`` steps from the scene's initial state at rest under
    ``fext`` -> (trajectory (frames, N, 3), {group: (frames, e * p, 3)
    projections of each frame's last sweep})."""
    eta = 1.0 - damping
    m = scene.masses
    lu = scipy.sparse.linalg.splu(global_block(scene, dt))
    mass_dt2 = (m / (dt * dt))[:, None]
    data = {k: tensor_data(g.data, "cpu", torch.float64)
            for k, g in scene.groups.items()}
    corners = {k: torch.as_tensor(corner_index(scene, k))
               for k in scene.groups}
    P = scene.positions.copy()
    V = np.zeros_like(P)
    a = fext / m[:, None]
    traj = np.empty((frames,) + P.shape)
    snaps = {k: np.empty((frames, g.num * g.p, 3))
             for k, g in scene.groups.items()}
    for t in range(frames):
        sn = P + dt * eta * V + dt * dt * a
        if scene.floor:
            sn[:, 1] = np.maximum(sn[:, 1], FLOOR_HEIGHT)
        q = sn
        for _ in range(iterations):
            b = mass_dt2 * sn
            qt = torch.as_tensor(q)
            for k, g in scene.groups.items():
                p = group_rows(k, qt[corners[k]], data[k])
                p = p.reshape(-1, 3).numpy()
                b = b + g.ST @ p
                snaps[k][t] = p
            q = lu.solve(np.ascontiguousarray(b))
        V = (q - P) / dt
        P = q
        traj[t] = P
    return traj, snaps
