"""Deformable model: simulation state + constraint-group management.

Counterpart of ``animsnapbases_tpu/sim/model.py``: pinning (``fix``, mass
1e10; ``unfix`` back to the initial mass, ``toggle_fixed``) with the side
and corner fixers and their releases, picking (``picked_vert``,
``toggle_picked``), positional targets (added and removed), the
constructors of the five constraint group kinds (``tris_strain``,
``edge_spring``, ``tets_strain``, ``tets_deformation_gradient``,
``verts_bending`` with its area masses), the S^T export
(``assembly_matrices``) and ``count_edges``.  The state stays host numpy in float64, as in the
JAX package; the solvers cast it to their dtype on their device.
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
        self.mass_init = self.mass.copy()
        self.velocities = np.zeros_like(self.positions)

        self.fixed_flags = np.zeros(n, dtype=bool)
        self.picked_vert = np.zeros(n, dtype=bool)
        self.threshold_fixing_ratio = 0.01
        self.groups: dict[str, G.ConstraintGroup] = {}
        # dynamic positional constraints kept as host lists
        self._positional: list[dict] = []

    @property
    def n_verts(self) -> int:
        return self.positions.shape[0]

    def reset_constraints_attributes(self):
        self.groups = {}
        self._positional = []

    def is_fixed(self, i):
        return bool(self.fixed_flags[i])

    def fix(self, i):
        self.fixed_flags[i] = True
        self.mass[i] = 1e10

    def unfix(self, i):
        self.fixed_flags[i] = False
        self.mass[i] = self.mass_init[i]

    def toggle_fixed(self, i, mass_when_unfixed=1.0):
        self.fixed_flags[i] = ~self.fixed_flags[i]
        self.mass[i] = 1e10 if self.fixed_flags[i] else mass_when_unfixed

    def toggle_picked(self, i):
        self.picked_vert[i] = ~self.picked_vert[i]

    def immobilize(self):
        self.velocities[:] = 0

    # ------------------------------------------------------------------
    # side / corner fixers
    # ------------------------------------------------------------------

    def compute_cloth_corner_indices(self):
        """The surface vertices within ``threshold_fixing_ratio`` of the
        x and y extents, per side (left, right, bottom, top)."""
        x, y = self.positions[:, 0], self.positions[:, 1]
        x_thresh = self.threshold_fixing_ratio * (x.max() - x.min())
        y_thresh = self.threshold_fixing_ratio * (y.max() - y.min())
        surface = (np.unique(self.faces.flatten()) if self.faces.size
                   else np.arange(len(x)))
        self._side_surface_verts = {}
        for side, mask in (
                ("left", x <= x.min() + x_thresh),
                ("right", x >= x.max() - x_thresh),
                ("bottom", y <= y.min() + y_thresh),
                ("top", y >= y.max() - y_thresh)):
            self._side_surface_verts[side] = np.intersect1d(
                np.where(mask)[0], surface)

    def fix_side_vertices(self, threshold=None, side="left", axis=0):
        """Pin the vertices below (``side="left"``) or above ``threshold``
        along ``axis`` (default: the mean)."""
        V = self.positions
        if threshold is None:
            threshold = V[:, axis].mean()
        if side == "left":
            sel = np.where(V[:, axis] < threshold)[0]
        else:
            sel = np.where(V[:, axis] > threshold)[0]
        for i in sel:
            self.fix(i)

    def fix_surface_side_vertices(self, side="left", return_target=False):
        """Pin the surface vertices of one side
        (:meth:`compute_cloth_corner_indices`)."""
        if not hasattr(self, "_side_surface_verts"):
            self.compute_cloth_corner_indices()
        targets = self._side_surface_verts.get(side, [])
        for vi in targets:
            self.fix(vi)
        if return_target:
            return targets

    def release_surface_side_vertices(self, side="left"):
        """Unpin the surface vertices of one side."""
        if not hasattr(self, "_side_surface_verts"):
            self.compute_cloth_corner_indices()
        for vi in self._side_surface_verts.get(side, []):
            self.unfix(vi)

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

    def remove_positional_constraint(self, vi):
        self._positional = [c for c in self._positional if c["vi"] != vi]
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

    def add_tet_constrain_strain(self, sigma_min, sigma_max, wi=1e6):
        self.groups["tets_strain"] = G.build_tets_strain(
            self.elements, wi, self.positions, sigma_min, sigma_max)

    def add_tet_constrain_deformation_gradient(self, wi=1e6):
        self.groups["tets_deformation_gradient"] = (
            G.build_tets_deformation_gradient(self.elements, wi,
                                              self.positions))

    def add_vertex_bending_constraint(self, wi=1e6, prevent_bending_flips=True,
                                      flat_bending=False):
        voronoi = self.vertex_masses(self.faces, self.positions)
        self.groups["verts_bending"] = G.build_verts_bending(
            self.positions, self.faces, wi, voronoi, prevent_bending_flips,
            flat_bending)

    def count_edges(self, faces=None) -> int:
        """Number of unique undirected edges."""
        faces = self.faces if faces is None else faces
        return len(unique_edges(faces))

    def has_group(self, name: str) -> bool:
        return name in self.groups

    def assembly_matrices(self) -> dict:
        """scipy S^T matrices per group but the positional one (the
        ``assembly_ST.npz`` export)."""
        return {name: g.assembly_scipy(self.n_verts)
                for name, g in self.groups.items() if name != "positional"}

    def vertex_masses(self, triangles, positions):
        """Per-vertex area masses (a third of each incident triangle),
        floored at 1e-7."""
        v = np.zeros(len(positions))
        p = positions
        f = np.asarray(triangles, dtype=np.int64)
        areas = 0.5 * np.linalg.norm(
            np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]]),
            axis=1) / 3.0
        for k in range(3):
            np.add.at(v, f[:, k], areas)
        v[v < 1e-7] = 1e-7
        return v
