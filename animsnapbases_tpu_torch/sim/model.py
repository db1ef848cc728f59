"""Deformable model: simulation state + constraint-group management.

Counterpart of ``animsnapbases_tpu/sim/model.py`` for what the reduced
serving path needs: pinning (``fix``, mass 1e10), positional targets, and
the ``tris_strain`` / ``edge_spring`` group constructors.  The state stays
host numpy in float64, as in the JAX package; the solver casts it once
per call to the working dtype on its device.
"""

from __future__ import annotations

import numpy as np

from animsnapbases_tpu_torch.geometry.mesh import tet_edges, unique_edges
from animsnapbases_tpu_torch.sim import groups as G


class DeformableModel:
    def __init__(self, positions, faces, elements=None, masses=None,
                 floor_collision: bool = True, init_height_shift: float = 2.0):
        self.floor_height = 0.0
        self.floor_collision = floor_collision
        self.init_height_shift = init_height_shift

        self.init_positions = np.array(positions, dtype=float)
        if self.floor_collision:
            self.init_positions[:, 1] += self.init_height_shift
        self.positions = self.init_positions.copy()
        self.positions_corrections = np.zeros_like(self.positions)
        self.faces = np.array(faces, dtype=np.int64)
        self.elements = (np.array(elements, dtype=np.int64)
                         if elements is not None
                         else np.empty((0, 4), dtype=np.int64))

        n = self.positions.shape[0]
        self.mass = np.ones(n) if masses is None else np.array(masses,
                                                               dtype=float)
        self.velocities = np.zeros_like(self.positions)

        self.fixed_flags = np.zeros(n, dtype=bool)
        self.groups: dict[str, G.ConstraintGroup] = {}
        # dynamic positional constraints kept as host lists
        self._positional: list[dict] = []

    @property
    def n_verts(self) -> int:
        return self.positions.shape[0]

    def fix(self, i):
        self.fixed_flags[i] = True
        self.mass[i] = 1e10

    # ------------------------------------------------------------------
    # constraint constructors
    # ------------------------------------------------------------------

    def add_positional_constraint(self, vi, wi=1e9, motion_type="fixed",
                                  frame_shift=None):
        self._positional.append({
            "vi": int(vi), "wi": float(wi), "motion_type": motion_type,
            "frame_shift": (np.asarray(frame_shift)
                            if frame_shift is not None else None),
        })
        self._rebuild_positional()

    def _rebuild_positional(self):
        if not self._positional:
            self.groups.pop("positional", None)
            return
        idx = [c["vi"] for c in self._positional]
        wi = self._positional[0]["wi"]
        g = G.build_positional(
            idx, wi, self.positions,
            motion_types=[c["motion_type"] for c in self._positional],
            frame_shifts=[c["frame_shift"] for c in self._positional])
        # per-constraint weights may differ
        g.data["wi"] = np.array([c["wi"] for c in self._positional])
        g.st_vals = g.data["wi"].astype(float)
        g.lhs_vals = np.repeat(g.data["wi"], 3).astype(float)
        self.groups["positional"] = g

    def positional_targets(self, frame: int) -> np.ndarray:
        """(e, 3) projection targets for the current frame."""
        g = self.groups.get("positional")
        if g is None:
            return np.zeros((0, 3))
        out = g.data["p0"].copy()
        for i, c in enumerate(self._positional):
            if (c["motion_type"] == "user_defined"
                    and c["frame_shift"] is not None):
                shift = c["frame_shift"]
                out[i] += shift[min(frame, len(shift) - 1)]
        return out

    def add_edge_spring_constraint(self, wi=1e6):
        if self.elements.shape[0]:
            E = tet_edges(self.elements)
        else:
            E = unique_edges(self.faces)
        self.groups["edge_spring"] = G.build_edge_spring(E, wi, self.positions)

    def add_tri_constrain_strain(self, sigma_min, sigma_max, wi=1e6):
        self.groups["tris_strain"] = G.build_tris_strain(
            self.faces, wi, self.positions, sigma_min, sigma_max)
