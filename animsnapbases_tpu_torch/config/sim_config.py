"""Simulator arguments.

Counterpart of ``animsnapbases_tpu/config/sim_config.py``: the same
``default_sim_args`` namespace with the same defaults, copied so the port
imports nothing of the JAX package.  The JSON config loader is not ported.
"""

from __future__ import annotations

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
