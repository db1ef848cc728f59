"""Interactive simulation handlers, decoupled from any window system.

Counterpart of ``animsnapbases_tpu/sim/interaction.py`` (host numpy; the
solver steps on its own device).  Shift-click pins a vertex and
adds a positional constraint; ctrl-click picks a vertex for dragging; mouse
movement converts the screen-space delta into an external force on the
picked vertex; the per-frame handler syncs masses, applies gravity,
re-prepares when dirty, and steps.  All handlers consume abstract
(x, y, modifier) events, so they can be driven by polyscope, a web viewer,
or a test harness alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PhysicsParams:
    """The physics panel's values."""
    mass_per_particle: float = 10.0
    is_gravity_active: bool = True
    dt: float = 1.0 / 60.0
    solver_iterations: int = 10
    positional_constraint_wi: float = 1e9
    drag_force_scale: float = 400.0


@dataclass
class PickingState:
    """The pick-and-drag state."""
    is_picking: bool = False
    picked_vertex: int = -1
    mouse_x: float = 0.0
    mouse_y: float = 0.0


def nearest_vertex_screen(positions: np.ndarray, project_fn,
                          x: float, y: float) -> int:
    """Closest vertex to a screen point under a projection callback
    project_fn(world (N,3)) -> screen (N,2)."""
    screen = project_fn(positions)
    d = np.linalg.norm(screen - np.array([x, y]), axis=1)
    return int(np.argmin(d))


class MouseDownHandler:
    """Shift-click: toggle pin + positional constraint; ctrl-click: pick for
    dragging."""

    def __init__(self, model, solver, params: PhysicsParams,
                 picking: PickingState, project_fn):
        self.model = model
        self.solver = solver
        self.params = params
        self.picking = picking
        self.project_fn = project_fn

    def handle_click(self, x: float, y: float, shift: bool = False,
                     ctrl: bool = False) -> int | None:
        v = nearest_vertex_screen(self.model.positions, self.project_fn, x, y)
        if shift:
            if self.model.is_fixed(v):
                self.model.unfix(v)
                self.model.remove_positional_constraint(v)
            else:
                self.model.fix(v)
                self.model.add_positional_constraint(
                    v, self.params.positional_constraint_wi)
            self.solver.set_dirty()
            return v
        if ctrl:
            self.picking.is_picking = True
            self.picking.picked_vertex = v
            self.picking.mouse_x = x
            self.picking.mouse_y = y
            self.model.toggle_picked(v)
            return v
        return None

    def handle_release(self):
        if self.picking.is_picking:
            if self.picking.picked_vertex >= 0:
                self.model.picked_vert[self.picking.picked_vertex] = False
            self.picking.is_picking = False
            self.picking.picked_vertex = -1


class MouseMoveHandler:
    """Screen-space drag delta -> external force on the picked vertex."""

    def __init__(self, model, picking: PickingState, fext: np.ndarray,
                 params: PhysicsParams, unproject_dir_fn=None):
        self.model = model
        self.picking = picking
        self.fext = fext
        self.params = params
        # maps a screen delta (dx, dy) to a world-space direction
        self.unproject_dir_fn = unproject_dir_fn or (
            lambda dx, dy: np.array([dx, -dy, 0.0]))

    def handle_move(self, x: float, y: float) -> bool:
        if not self.picking.is_picking or self.picking.picked_vertex < 0:
            return False
        dx = x - self.picking.mouse_x
        dy = y - self.picking.mouse_y
        direction = self.unproject_dir_fn(dx, dy)
        self.fext[self.picking.picked_vertex] += (
            self.params.drag_force_scale * direction)
        self.picking.mouse_x = x
        self.picking.mouse_y = y
        return True


class PreDrawHandler:
    """Per-frame driver: mass sync, gravity, prepare-if-dirty, step, fext
    reset (the reference's pre-draw handler without the rendering)."""

    def __init__(self, is_model_ready, args, solver, fext,
                 record_info: bool = False, record_path: str | None = None,
                 capture_fn=None):
        self.is_model_ready = is_model_ready
        self.physics_params = args
        self.solver = solver
        self.fext = fext
        self._animating = False
        self.record_info = record_info
        self.record_path = record_path
        # per-frame capture hook (the reference saves a polyscope
        # screenshot per frame); window-agnostic here: see
        # make_headless_capture for the PNG default
        self.capture_fn = capture_fn

    def set_animating(self, flag: bool):
        self._animating = flag

    def handle(self):
        if not self.is_model_ready():
            return
        model = self.solver.model
        mass_value = float(self.physics_params.mass_per_particle)

        unfixed = ~model.fixed_flags
        stale = unfixed & ~np.isclose(model.mass, mass_value, atol=1e-5)
        if stale.any():
            model.mass[stale] = mass_value
            self.solver.set_dirty()

        if self._animating:
            if self.physics_params.is_gravity_active:
                self.fext[:, 1] -= 9.81 * mass_value
            if not self.solver.ready():
                self.solver.prepare(self.physics_params,
                                    store_fom_info=self.record_info,
                                    record_path=self.record_path)
            self.solver.step(self.fext,
                             self.physics_params.solver_iterations)
            self.fext[:] = 0.0
            if self.capture_fn is not None:
                self.capture_fn(self.solver.frame)


def make_headless_capture(model, out_dir: str, every: int = 1):
    """Default capture hook: renders the model surface to
    ``out_dir/frame_{n}.png`` every ``every`` frames via the headless
    matplotlib renderer (polyscope screenshot equivalent)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    every = max(1, int(every))

    def capture(frame: int):
        if frame % every:
            return
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from animsnapbases_tpu_torch.analysis.viewer import _render_mesh

        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
        _render_mesh(ax, np.asarray(model.positions),
                     np.asarray(model.faces)[:, :3])
        fig.savefig(os.path.join(out_dir, f"frame_{frame}.png"), dpi=72)
        plt.close(fig)

    return capture
