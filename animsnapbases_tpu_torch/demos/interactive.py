"""Interactive simulation session: the headless equivalent of the
reference's imgui control panel.

Counterpart of ``animsnapbases_tpu/demos/interactive.py``.  Everything the
panel toggles is a method here: constraint sets and weights, gravity, side
fixing, solver choice (full vs reduced), reset, stepping, and the pick/drag
handlers of :mod:`animsnapbases_tpu_torch.sim.interaction`.  A GUI
(polyscope, web, notebook) can bind buttons to these methods 1:1; tests and
scripts drive them directly.  The solver runs on ``device`` (default the
card).
"""

from __future__ import annotations

import numpy as np

from animsnapbases_tpu_torch.demos.scenarios import (
    add_configured_constraints,
    get_solver,
    rescale,
)
from animsnapbases_tpu_torch.geometry.procedural import (
    bar_model,
    cloth_model,
)
from animsnapbases_tpu_torch.sim.interaction import (
    MouseDownHandler,
    MouseMoveHandler,
    PickingState,
)
from animsnapbases_tpu_torch.sim.model import DeformableModel


class InteractiveSession:
    def __init__(self, args, system: str = "Cloth", params=None,
                 device=None):
        self.args = args
        self.system = system
        self.device = device
        if params is not None:
            params.edit_system_args(args, system)
        self.picking = PickingState()
        self.fext = None
        self.model: DeformableModel | None = None
        self.solver = None
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        args = self.args
        if self.system == "Bar":
            V, T, F, _ = bar_model(args.bar_width, args.bar_height,
                                   args.bar_depth)
        else:
            V, F = cloth_model(args.cloth_width, args.cloth_height)
            T = None
        V = rescale(V)
        self.model = DeformableModel(
            V, F, elements=T,
            masses=np.full(len(V), args.mass_per_particle),
            floor_collision=True)
        self.fext = np.zeros_like(self.model.positions)
        self.solver = get_solver(args, device=self.device)
        self.solver.set_model(self.model)
        self.rebuild_constraints()

    def rebuild_constraints(self):
        self.model.reset_constraints_attributes()
        add_configured_constraints(self.model, self.args)
        self.solver.set_dirty()

    # ------------------------------------------------------------------
    # panel controls
    # ------------------------------------------------------------------

    def set_constraint(self, name: str, enabled: bool, wi: float | None = None):
        """name in {vert_bending, edge, tri_strain, tet_strain,
        tet_deformation}."""
        flag = {"vert_bending": "vert_bending_constraint",
                "edge": "edge_constraint",
                "tri_strain": "tri_strain_constraint",
                "tet_strain": "tet_strain_constraint",
                "tet_deformation": "tet_deformation_constraint"}[name]
        setattr(self.args, flag, enabled)
        if wi is not None:
            wmap = {"vert_bending": "vert_bending_constraint_wi",
                    "edge": "edge_constraint_wi",
                    "tri_strain": "strain_limit_constraint_wi",
                    "tet_strain": "strain_limit_constraint_wi",
                    "tet_deformation":
                        "deformation_gradient_constraint_wi"}[name]
            setattr(self.args, wmap, wi)
        self.rebuild_constraints()

    def set_gravity(self, enabled: bool):
        self.args.is_gravity_active = enabled

    def set_sigma_range(self, smin: float, smax: float):
        self.args.sigma_min = smin
        self.args.sigma_max = smax
        self.rebuild_constraints()

    def fix_side(self, side: str):
        self.model.compute_cloth_corner_indices()
        self.model.fix_surface_side_vertices(side=side)
        self.solver.set_dirty()

    def release_side(self, side: str):
        self.model.release_surface_side_vertices(side=side)
        self.solver.set_dirty()

    def mouse_handlers(self, project_fn):
        from animsnapbases_tpu_torch.sim.interaction import PhysicsParams

        params = PhysicsParams(
            mass_per_particle=self.args.mass_per_particle,
            positional_constraint_wi=self.args.positional_constraint_wi)
        down = MouseDownHandler(self.model, self.solver, params,
                                self.picking, project_fn)
        move = MouseMoveHandler(self.model, self.picking, self.fext, params)
        return down, move

    # ------------------------------------------------------------------
    def step(self, n: int = 1):
        args = self.args
        for _ in range(n):
            mass_value = float(args.mass_per_particle)
            unfixed = ~self.model.fixed_flags
            stale = unfixed & ~np.isclose(self.model.mass, mass_value,
                                          atol=1e-5)
            if stale.any():
                self.model.mass[stale] = mass_value
                self.solver.set_dirty()
            if args.is_gravity_active:
                self.fext[:, 1] -= 9.81 * mass_value
            if not self.solver.ready():
                self.solver.prepare(args)
            self.solver.step(self.fext, args.solver_iterations)
            self.fext[:] = 0.0

    def stats(self) -> dict:
        """The panel's stat overlay values."""
        m = self.model
        out = {
            "vertices": int(m.positions.shape[0]),
            "triangles": int(m.faces.shape[0]),
            "tetrahedra": int(m.elements.shape[0]),
            "frame": self.solver.frame,
        }
        for name, g in m.groups.items():
            out[f"{name}_constraints"] = g.num
        return out
