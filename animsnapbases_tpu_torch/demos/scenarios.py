"""Headless scripted demo scenarios.

Counterpart of ``animsnapbases_tpu/demos/scenarios.py``.  Each scenario
builds the model at frame 0 (exporting the mesh to .obj/.mesh), applies
the configured constraints, then follows a frame-keyed schedule of
fix/release events or timed pokes, recording constraint projections
(``<group>_p.npz``), assembly matrices and, optionally, the
position-snapshot sequence (``pos_%d.off``) the position pipeline imports.

The per-frame driver syncs the unfixed masses to ``mass_per_particle``
(dirtying the solver on a change), applies gravity as a constant
per-vertex force, prepares again when dirty, and steps.  Between schedule
events the frames go through ``solver.run_steps(..., record=True)`` in one
call: on the reduced solver, fully reduced, that is kernel 1 once a step
(``ops/fused_reduced.py``).  Every fix or release event marks the solver
dirty, so the next call prepares it again (the global matrix and, on the
reduced solver, kernel 1's operands and staging plan).

The solvers take ``device`` (default the card, as every entry point of the
port); the model, the schedule and the files stay on the host.
"""

from __future__ import annotations

import os

import numpy as np

from animsnapbases_tpu_torch.demos.poke import (
    create_poke_z_motion_with_jumps,
    voronoi_seeds_and_partition,
)
from animsnapbases_tpu_torch.geometry.procedural import (
    bar_model,
    cloth_model,
)
from animsnapbases_tpu_torch.io.meshes import (
    save_medit_mesh,
    save_obj,
    save_off,
)
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from animsnapbases_tpu_torch.sim.solver import Solver


def rescale(V: np.ndarray) -> np.ndarray:
    """Normalize into the unit box around the origin."""
    V = V - V.min(axis=0)
    extent = V.max(axis=0) - V.min(axis=0)
    scale = extent.max()
    return (V / scale - 0.5) if scale > 0 else V


def get_solver(args, device=None):
    """The solver ``args.solver`` names on ``device`` (default the card)."""
    if args.solver == "animSnapBasesSolver":
        return AnimSnapBasesSolver(args, device=device)
    return Solver(device=device)


def recording_subpath(args, model, object_name: str, experiment: str) -> str:
    """The reference's self-describing recording path: constraint names,
    weights and reduction tags."""
    constrproj_case = "constraint_projection/FOM"
    if getattr(args, "constraint_projection_basis_type", ""):
        reduced_any = any(getattr(args, f, False) for f in (
            "vert_bending_reduced", "edge_spring_reduced",
            "tri_strain_reduced", "tet_strain_reduced",
            "tet_deformation_reduced"))
        if reduced_any:
            constrproj_case = ("constraint_projection/"
                               + args.constraint_projection_basis_type)

    specify = ""
    if model.has_group("verts_bending"):
        specify += f"verts_bending_wi{args.vert_bending_constraint_wi}_"
        if args.vert_bending_reduced:
            specify += f"reduced_{args.vert_bending_num_components}_"
    if model.has_group("edge_spring"):
        specify += f"edge_spring_wi{args.edge_constraint_wi}_"
        if args.edge_spring_reduced:
            specify += f"reduced_{args.edge_spring_num_components}_"
    if model.has_group("tris_strain"):
        specify += f"tris_strain_wi{args.strain_limit_constraint_wi}_"
        if args.tri_strain_reduced:
            specify += f"reduced_{args.tri_strain_num_components}_"
    if model.has_group("tets_strain"):
        specify += f"tets_strain_wi{args.strain_limit_constraint_wi}_"
        if args.tet_strain_reduced:
            specify += f"reduced_{args.tet_strain_num_components}_"
    if model.has_group("tets_deformation_gradient"):
        specify += ("tets_deformation_gradient_wi"
                    f"{args.deformation_gradient_constraint_wi}_")
        if args.tet_deformation_reduced:
            specify += f"reduced_{args.tet_deformation_num_components}_"

    return os.path.join(object_name, experiment, constrproj_case, specify)


def add_configured_constraints(model, args):
    if args.vert_bending_constraint:
        model.add_vertex_bending_constraint(args.vert_bending_constraint_wi)
    if args.edge_constraint:
        model.add_edge_spring_constraint(args.edge_constraint_wi)
    if args.tri_strain_constraint:
        model.add_tri_constrain_strain(args.sigma_min, args.sigma_max,
                                       args.strain_limit_constraint_wi)
    if args.tet_strain_constraint:
        model.add_tet_constrain_strain(args.sigma_min, args.sigma_max,
                                       args.strain_limit_constraint_wi)
    if args.tet_deformation_constraint:
        model.add_tet_constrain_deformation_gradient(
            args.deformation_gradient_constraint_wi)


class ScenarioDriver:
    """Runs a scenario's schedule headlessly."""

    def __init__(self, args, object_name: str, experiment: str,
                 build_geometry, schedule, stop_frame: int,
                 record_fom_info: bool = False,
                 record_positions: bool = False,
                 record_screenshots: bool = False,
                 viewer=None, device=None):
        self.args = args
        self.object_name = object_name
        self.experiment = experiment
        self.build_geometry = build_geometry
        self.schedule = schedule          # dict frame -> fn(self) + callables
        self.stop_frame = stop_frame
        self.record_fom_info = record_fom_info
        self.record_positions = record_positions
        self.record_screenshots = record_screenshots
        self.viewer = viewer

        self.model: DeformableModel | None = None
        self.solver = get_solver(args, device=device)
        self.output_path = args.output_dir
        self.record_path = None
        self.pos_dir = None
        self.shots_dir = None
        self.trajectory: list[np.ndarray] = []

    # ------------------------------------------------------------------
    def _frame0(self):
        V, F, T = self.build_geometry(self.args)
        V = rescale(V)
        self.model = DeformableModel(
            V, F, elements=T,
            masses=np.full(len(V), self.args.mass_per_particle),
            floor_collision=True,
            init_height_shift=1.0 if T is not None and len(T) else 2.0)
        self.solver.set_model(self.model)

        obj_dir = os.path.join(self.output_path, self.object_name)
        os.makedirs(obj_dir, exist_ok=True)
        save_obj(os.path.join(obj_dir, self.object_name + ".obj"),
                 self.model.positions, F)
        if T is not None and len(T):
            save_medit_mesh(os.path.join(obj_dir, self.object_name + ".mesh"),
                            self.model.positions, tets=T, tris=F)

        self.schedule.get("setup", lambda d: None)(self)
        self.model.immobilize()
        add_configured_constraints(self.model, self.args)
        self.schedule.get("after_constraints", lambda d: None)(self)

        if self.record_fom_info:
            sub = recording_subpath(self.args, self.model, self.object_name,
                                    self.experiment)
            self.record_path = os.path.join(self.output_path, sub)
            os.makedirs(self.record_path, exist_ok=True)
            self.solver.set_record_path(self.record_path)
            self.solver.set_store_p(True)
            # flush no later than the scenario's last simulated frame
            # (set on args: prepare() re-reads it from there)
            self.args.max_p_snapshots_num = min(
                getattr(self.args, "max_p_snapshots_num",
                        self.stop_frame - 1),
                self.stop_frame - 1)
            self.solver.max_p_snapshots_num = self.args.max_p_snapshots_num
        if self.record_positions:
            # layout matches the bases config's snapshot pattern:
            # <experiment_dir>/<mesh>/<experiment>/position_snapshots/FOM
            self.pos_dir = os.path.join(
                self.output_path, self.object_name, self.experiment,
                "position_snapshots", "FOM")
            os.makedirs(self.pos_dir, exist_ok=True)
        if self.record_screenshots:
            # per-frame render to PNG (the reference saves a polyscope
            # screenshot every pre-draw when the
            # screenshot flag is on); headless, exported from the captured
            # trajectory at the end of run()
            self.shots_dir = os.path.join(
                self.output_path, self.object_name, self.experiment,
                "screenshots")
            os.makedirs(self.shots_dir, exist_ok=True)
        self.solver.set_dirty()

    # ------------------------------------------------------------------
    def run(self, max_frames: int | None = None, chunked: bool = True):
        """Run the schedule to ``stop_frame``.

        ``chunked=True`` (default) advances the frames between schedule
        events through ``solver.run_steps(..., record=True)``, one call per
        event gap with the per-frame trajectory captured on the device,
        instead of one call per frame.  Scenarios with an
        ``every_frame`` tick (e.g. the poke factory, which edits
        constraints each cycle) or a live viewer keep the per-frame loop.
        """
        stop = self.stop_frame if max_frames is None else min(
            self.stop_frame, max_frames)
        use_chunks = (chunked and self.viewer is None
                      and "every_frame" not in self.schedule)
        while True:
            frame = self.solver.frame
            if frame == 0 and self.model is None:
                self._frame0()
            action = self.schedule.get(frame)
            if action is not None and frame > 0:
                action(self)
                # fix/release events change the pinned-mass pattern; the
                # prefactored global matrix must be rebuilt (the reference
                # demos call solver.set_dirty() in every such callback)
                self.solver.set_dirty()
            tick = self.schedule.get("every_frame")
            if tick is not None:
                tick(self)
            if frame >= stop:
                break
            if use_chunks:
                nxt = min([k for k in self.schedule
                           if isinstance(k, int) and k > frame] + [stop])
                if nxt - frame > 1 and self._chunk_steps(nxt - frame):
                    continue
            self._pre_draw_step()
        if self.record_fom_info and hasattr(self.solver, "flush_recordings"):
            self.solver.flush_recordings()
        if self.shots_dir is not None:
            self._export_screenshots()
        return self

    def _export_screenshots(self):
        """One PNG per simulated frame from the captured trajectory."""
        import matplotlib.pyplot as plt

        from animsnapbases_tpu_torch.analysis.viewer import _render_mesh

        for i, P in enumerate(self.trajectory):
            fig = plt.figure(figsize=(6, 6))
            ax = fig.add_subplot(111, projection="3d")
            _render_mesh(ax, np.asarray(P), self.model.faces)
            fig.savefig(os.path.join(self.shots_dir,
                                     f"screenshot_{i:04d}.png"), dpi=90)
            plt.close(fig)

    def _sync_and_prepare(self):
        """Mass resync + gravity + prepare-if-dirty (shared between the
        per-frame and chunked paths: a one-sided edit here would
        desynchronize them).  Returns fext."""
        model = self.model
        args = self.args
        mass_value = float(args.mass_per_particle)
        unfixed = ~model.fixed_flags
        stale = unfixed & ~np.isclose(model.mass, mass_value, atol=1e-5)
        if stale.any():
            model.mass[stale] = mass_value
            self.solver.set_dirty()
        fext = np.zeros_like(model.positions)
        if args.is_gravity_active:
            fext[:, 1] -= 9.81 * mass_value
        if not self.solver.ready():
            self.solver.prepare(args,
                                store_fom_info=self.record_fom_info,
                                record_path=self.record_path)
        return fext

    def _chunk_steps(self, n: int) -> bool:
        """Advance ``n`` frames in one ``run_steps`` call (same setup as
        :meth:`_pre_draw_step`, the trajectory captured on the device).
        Returns False when the solver has no ``run_steps``: the caller
        falls back to the per-frame loop."""
        run_steps = getattr(self.solver, "run_steps", None)
        if run_steps is None:
            return False
        model = self.model
        fext = self._sync_and_prepare()
        first_frame = self.solver.frame
        traj = run_steps(fext, n, self.args.solver_iterations, record=True)
        if traj is None:
            # a solver that advanced without capturing would silently
            # drop frames from trajectory/pos exports: refuse and let
            # the per-frame loop take over (unreachable: both solvers
            # return the trajectory when record=True)
            return False
        self.trajectory.extend(np.asarray(f, dtype=float) for f in traj)
        if self.pos_dir is not None:
            for i, f in enumerate(traj):
                save_off(os.path.join(self.pos_dir,
                                      f"pos_{first_frame + i}.off"),
                         np.asarray(f, dtype=float), model.faces)
        return True

    def _pre_draw_step(self):
        """Mass sync + gravity + prepare-if-dirty + step + snapshot
        export."""
        model = self.model
        fext = self._sync_and_prepare()
        self.solver.step(fext, self.args.solver_iterations)
        self.trajectory.append(model.positions.copy())

        if self.pos_dir is not None:
            save_off(os.path.join(self.pos_dir,
                                  f"pos_{self.solver.frame - 1}.off"),
                     model.positions, model.faces)
        if self.viewer is not None:
            self.viewer(self)


# ---------------------------------------------------------------------------
# scenario definitions
# ---------------------------------------------------------------------------

def _bar_geometry(args):
    V, T, F, _ = bar_model(args.bar_width, args.bar_height, args.bar_depth)
    return V, F, T


def _cloth_geometry(args):
    V, F = cloth_model(args.cloth_width, args.cloth_height)
    return V, F, None


def bar_automated_deformationgradient(args, record_fom_info=False,
                                      params=None, **kw):
    """Fix both bar sides; release left @40, right @80, stop @144."""
    if params is not None:
        params.edit_system_args(args, "Bar")

    schedule = {
        "setup": lambda d: (
            d.model.fix_surface_side_vertices(side="left"),
            d.model.fix_surface_side_vertices(side="right")),
        40: lambda d: d.model.release_surface_side_vertices(side="left"),
        80: lambda d: d.model.release_surface_side_vertices(side="right"),
    }
    return ScenarioDriver(args, "bar", "bar_automated_deformationgradient",
                          _bar_geometry, schedule, stop_frame=144,
                          record_fom_info=record_fom_info, **kw)


def cloth_automated_bend_spring_strain(args, record_fom_info=False,
                                       params=None, **kw):
    """Side fix/release schedule @20/60/140, stop @240."""
    if params is not None:
        params.edit_system_args(args, "Cloth")

    def setup(d):
        d.model.compute_cloth_corner_indices()
        d.model.fix_surface_side_vertices(side="top")
        d.model.fix_surface_side_vertices(side="bottom")

    schedule = {
        "setup": setup,
        20: lambda d: d.model.release_surface_side_vertices(side="bottom"),
        60: lambda d: (
            d.model.fix_surface_side_vertices(side="bottom"),
            d.model.release_surface_side_vertices(side="top")),
        140: lambda d: (
            d.model.release_surface_side_vertices(side="top"),
            d.model.release_surface_side_vertices(side="bottom"),
            d.model.fix_surface_side_vertices(side="right")),
    }
    return ScenarioDriver(args, "cloth", "cloth_automated_bend_spring_strain",
                          _cloth_geometry, schedule, stop_frame=240,
                          record_fom_info=record_fom_info, **kw)


def cloth_automated_strain(args, record_fom_info=False, params=None, **kw):
    """Free fall with strain constraints, stop @220."""
    if params is not None:
        params.edit_system_args(args, "Cloth")
    return ScenarioDriver(args, "cloth", "cloth_automated_strain",
                          _cloth_geometry, {}, stop_frame=220,
                          record_fom_info=record_fom_info, **kw)


def cloth_automated_bend(args, record_fom_info=False, params=None, **kw):
    """Bending-only fall, stop @55."""
    if params is not None:
        params.edit_system_args(args, "Cloth")
    return ScenarioDriver(args, "cloth", "cloth_automated_bend",
                          _cloth_geometry, {}, stop_frame=55,
                          record_fom_info=record_fom_info, **kw)


def cloth_automated_spring(args, record_fom_info=False, params=None, **kw):
    if params is not None:
        params.edit_system_args(args, "Cloth")
    return ScenarioDriver(args, "cloth", "cloth_automated_spring",
                          _cloth_geometry, {}, stop_frame=220,
                          record_fom_info=record_fom_info, **kw)


def cloth_snapshots(args, record_fom_info=False, params=None,
                    poking_frames_per_point=20, rest_frames_per_point=10,
                    number_pokes=15, **kw):
    """Poking generator: FPS/Voronoi seeds on the cloth, z-poke trajectories
    via moving positional constraints added/removed each cycle."""
    if params is not None:
        params.edit_system_args(args, "Cloth")

    cycle = poking_frames_per_point + rest_frames_per_point
    total_frames = number_pokes * cycle
    state = {}

    def setup(d):
        d.model.compute_cloth_corner_indices()
        d.model.fix_surface_side_vertices(side="top")
        state["series"] = create_poke_z_motion_with_jumps(
            poking_frames_per_point, rest_frames_per_point, number_pokes,
            z_range=0.2)
        state["points"], _ = voronoi_seeds_and_partition(
            d.model.positions, d.model.faces, number_pokes)

    def after_constraints(d):
        d.model.add_positional_constraint(
            state["points"][0], args.positional_constraint_wi,
            motion_type="user_defined", frame_shift=state["series"])
        d.model.picked_vert[state["points"][0]] = True

    def every_frame(d):
        frame = d.solver.frame
        if frame <= 0:
            return
        if frame % cycle == 0:
            i = frame // cycle
            if i <= number_pokes:
                d.model.add_positional_constraint(
                    state["points"][i], args.positional_constraint_wi,
                    motion_type="user_defined", frame_shift=state["series"])
                d.model.picked_vert[state["points"][i]] = True
                d.solver.set_dirty()
        elif frame % cycle == poking_frames_per_point:
            i = frame // cycle
            if i <= number_pokes:
                d.model.remove_positional_constraint(state["points"][i])
                d.model.picked_vert[state["points"][i]] = False
                d.solver.set_dirty()
        if frame == total_frames:
            d.model.release_surface_side_vertices(side="top")
            d.solver.set_dirty()

    schedule = {"setup": setup, "after_constraints": after_constraints,
                "every_frame": every_frame}
    return ScenarioDriver(args, "cloth", "cloth_automated_snapshots",
                          _cloth_geometry, schedule,
                          stop_frame=total_frames + rest_frames_per_point,
                          record_fom_info=record_fom_info, **kw)


def _volumetric_mesh_geometry(mesh_name):
    """Surface ``<mesh>.obj`` -> tet mesh through the repo's
    tetrahedralizer (the reference wraps tetgen for this).  Looks in
    ``args.mesh_data_dir``, with a coarse volumetric bar as the fallback
    when the mesh is not there or no directory is given (the JAX package
    defaults the directory to the reference's data mount; the port reads
    no path outside what it is given)."""
    def build(args):
        data_dir = getattr(args, "mesh_data_dir", "") or ""
        path = os.path.join(data_dir, mesh_name + ".obj")
        if data_dir and os.path.exists(path):
            from animsnapbases_tpu_torch.geometry.volume import tetrahedralize
            from animsnapbases_tpu_torch.io.meshes import load_obj

            V, F = load_obj(path)
            TV, IT, FB = tetrahedralize(V, F)
            return TV, FB, IT
        V, T, F, _ = bar_model(10, 5, 5)
        return V, F, T
    return build


def _mesh_gfall(mesh_name, stop_frame):
    """Gravity-fall recording scenario for a volumetric mesh: no pins,
    drop onto the floor under gravity with tet strain, the experiment
    behind the ``<mesh>_gFall`` example configs
    (configs/examples/{bunny,armadillo}_gFall_*.json)."""
    def scenario(args, record_fom_info=False, params=None, **kw):
        return ScenarioDriver(args, mesh_name, f"{mesh_name}_gFall",
                              _volumetric_mesh_geometry(mesh_name), {},
                              stop_frame=stop_frame,
                              record_fom_info=record_fom_info, **kw)
    scenario.__name__ = f"{mesh_name}_gFall"
    return scenario


bunny_gfall = _mesh_gfall("bunny", stop_frame=200)      # 200: the pos
# pipeline reads pos_0..pos_198 (numFrames 100 x increment 2)
armadillo_gfall = _mesh_gfall("armadillo", stop_frame=144)


SCENARIOS = {
    "bar_automated_deformationgradient": bar_automated_deformationgradient,
    "cloth_automated_bend_spring_strain": cloth_automated_bend_spring_strain,
    "cloth_automated_strain": cloth_automated_strain,
    "cloth_automated_bend": cloth_automated_bend,
    "cloth_automated_spring": cloth_automated_spring,
    "cloth_snapshots": cloth_snapshots,
    "bunny_gFall": bunny_gfall,
    "armadillo_gFall": armadillo_gfall,
    "testing": cloth_snapshots,
}


def build_scenario(name: str, args, record_fom_info=False, params=None, **kw):
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario '{name}'; "
                         f"available: {sorted(SCENARIOS)}")
    return SCENARIOS[name](args, record_fom_info=record_fom_info,
                           params=params, **kw)
