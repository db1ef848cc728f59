"""Simulator arguments.

Counterpart of ``animsnapbases_tpu/config/sim_config.py``: the same
``default_sim_args`` namespace with the same defaults, and the same JSON
loader ``SimConfig`` of the reference's sim configs (``configs/demos/*.json``,
the reference's key mapping), copied so the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace


_DEFAULTS = dict(
    # system
    system_name="not_yet_picked",
    bar_width=0, bar_height=0, bar_depth=0,
    cloth_width=0, cloth_height=0,
    # visualization
    window_open=True, is_simulating=False,
    # solver
    solver="Solver", dt=0.016, solver_iterations=10,
    # velocity damping per step (eta = 1 - damping in the predictor
    # s_n = q + dt*eta*v + dt^2 M^-1 f).  0 = exact reference semantics
    # (the reference has none); long-horizon serving should set a small
    # value (e.g. 1e-3) — hyper-reduction noise pumps chaotic modes
    # unboundedly in undamped runs past ~10^4 steps.
    damping=0.0,
    # physics
    mass_per_particle=10.0,
    vert_bending_constraint_wi=0.1,
    edge_constraint_wi=1e6,
    positional_constraint_wi=1e9,
    deformation_gradient_constraint_wi=0.0,
    strain_limit_constraint_wi=0.1,
    sigma_min=0.99, sigma_max=1.01,
    # constraint toggles
    apply_constraints=True,
    vert_bending_constraint=False,
    edge_constraint=False,
    tri_strain_constraint=False,
    tet_strain_constraint=False,
    tet_deformation_constraint=False,
    is_gravity_active=True,
    fix_left_side=False, fix_right_side=False,
    _fix_left_triggered=False, _fix_right_triggered=False,
    fix_left_corners=False, fix_right_corners=False,
    _fix_left_corners_triggered=False, _fix_right_corners_triggered=False,
    fix_top_corners=False, fix_bottom_corners=False,
    _fix_top_corners_triggered=False, _fix_bottom_corners_triggered=False,
    record_projection_data=False,
    # reduction
    constraint_projection_basis_type="",
    vert_bending_reduced=False, vert_bending_num_components=-1,
    edge_spring_reduced=False, edge_spring_num_components=-1,
    tri_strain_reduced=False, tri_strain_num_components=-1,
    tet_strain_reduced=False, tet_strain_num_components=-1,
    tet_deformation_reduced=False, tet_deformation_num_components=-1,
    position_reduced=False, position_num_components=-1,
    position_basis_file="",
    # snapshot recording
    max_p_snapshots_num=200, recodr_p_snapshots_info=True,
    # directories
    output_dir="output/",
    geom_interpolation_basis_dir="",
    geom_interpolation_basis_file="",
)


def default_sim_args() -> SimpleNamespace:
    return SimpleNamespace(**dict(_DEFAULTS))


class SimConfig:
    """Loads a demo JSON and materializes a namespace of solver/physics args,
    mirroring the reference key mapping (projective_dynamics/config.py)."""

    def __init__(self, json_path: str | None = None):
        self.system_params: dict = {}
        if json_path is not None:
            self.reset_parameters(json_path)

    def reset_parameters(self, json_path: str) -> None:
        if not os.path.exists(json_path):
            raise FileNotFoundError(f"Config file not found: {json_path}")
        with open(json_path) as f:
            self.system_params = json.load(f)

    def edit_system_args(self, args, system_name: str) -> None:
        """Apply the named system block's dimensions onto existing args
        (reference projective_dynamics/config.py:18-28)."""
        args.system_name = system_name
        for key, val in self.system_params.get("system", {}).get(
                system_name, {}).items():
            setattr(args, key, val)

    def build_args(self, system_name: str | None = None) -> SimpleNamespace:
        args = default_sim_args()
        sp = self.system_params
        if not sp:
            return args

        if system_name is not None:
            args.system_name = system_name
            sysblock = sp.get("system", {}).get(system_name, {})
            for key, val in sysblock.items():
                setattr(args, key, val)

        vis = sp.get("visualization_params", {})
        args.window_open = vis.get("window_open", args.window_open)
        args.is_simulating = vis.get("is_simulating", args.is_simulating)

        solver = sp.get("solver_params", {})
        # legacy schema (ref demos/config.json) keeps the vis flags inside
        # the solver block
        args.window_open = solver.get("window_open", args.window_open)
        args.is_simulating = solver.get("is_simulating", args.is_simulating)
        args.solver = solver.get("name", args.solver)
        args.dt = solver.get("dt", args.dt)
        args.solver_iterations = solver.get("solver_iterations",
                                            args.solver_iterations)
        args.damping = solver.get("damping", args.damping)

        physics = sp.get("physics_params", {})
        for key in ("mass_per_particle", "vert_bending_constraint_wi",
                    "edge_constraint_wi", "positional_constraint_wi",
                    "deformation_gradient_constraint_wi",
                    "strain_limit_constraint_wi", "sigma_min", "sigma_max"):
            if key in physics:
                setattr(args, key, physics[key])

        cons = sp.get("constraints", {})
        mapping = {
            "apply_constraints": "apply_constraints",
            "vert_bending_constraint": "vert_bending_constraint",
            "edge_spring_constraint": "edge_constraint",
            "edge_constraint": "edge_constraint",   # legacy key (config.json)
            "tri_strain_constraint": "tri_strain_constraint",
            "tet_strain_constraint": "tet_strain_constraint",
            "tet_deformation_constraint": "tet_deformation_constraint",
            "is_gravity_active": "is_gravity_active",
            "fix_left_side": "fix_left_side",
            "fix_right_side": "fix_right_side",
            "_fix_left_triggered": "_fix_left_triggered",
            "_fix_right_triggered": "_fix_right_triggered",
            "fix_left_corners": "fix_left_corners",
            "fix_right_corners": "fix_right_corners",
            "_fix_left_corners_triggered": "_fix_left_corners_triggered",
            "_fix_right_corners_triggered": "_fix_right_corners_triggered",
            "fix_top_corners": "fix_top_corners",
            "fix_bottom_corners": "fix_bottom_corners",
            "_fix_top_corners_triggered": "_fix_top_corners_triggered",
            "_fix_bottom_corners_triggered": "_fix_bottom_corners_triggered",
            "record_projection_data": "record_projection_data",
        }
        for json_key, attr in mapping.items():
            if json_key in cons:
                setattr(args, attr, cons[json_key])

        red = sp.get("constraint_projetions_reduction", {})
        args.constraint_projection_basis_type = red.get("name", "")
        red_mapping = {
            "vert_bending_reduced": "vert_bending_reduced",
            "num_verts_bending_components": "vert_bending_num_components",
            "edge_spring_reduced": "edge_spring_reduced",
            "edge_spring_num_components": "edge_spring_num_components",
            "tri_strain_reduced": "tri_strain_reduced",
            "tri_strain_num_components": "tri_strain_num_components",
            "tet_strain_reduced": "tet_strain_reduced",
            "tet_strain_num_components": "tet_strain_num_components",
            "tet_deformation_reduced": "tet_deformation_reduced",
            "tet_deformation_num_components": "tet_deformation_num_components",
            "position_reduced": "position_reduced",
            "position_num_components": "position_num_components",
            "position_basis_file": "position_basis_file",
        }
        for json_key, attr in red_mapping.items():
            if json_key in red:
                setattr(args, attr, red[json_key])

        nls = sp.get("nonlinear_snapshots", {})
        args.max_p_snapshots_num = nls.get("max_p_snapshots_num",
                                           args.max_p_snapshots_num)
        args.recodr_p_snapshots_info = nls.get("recodr_snapshots_info",
                                               args.recodr_p_snapshots_info)

        dirs = sp.get("directories", {})
        args.output_dir = dirs.get("output", args.output_dir)
        args.geom_interpolation_basis_dir = (
            dirs.get("geom_interpolation_basis_dir", "")
            + red.get("name", "") + red.get("properties", ""))
        args.geom_interpolation_basis_file = dirs.get(
            "geom_interpolation_basis_file", "")
        return args
