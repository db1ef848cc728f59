"""The record -> bases -> reduced-solver pipeline.

The steps ``bench.py`` takes with the JAX package (``_run_fom_and_bases_impl``,
``build_group_basis``, ``build_reduced_solver``) and the reference's own
workflow (record a full-order run, compute one constraint group's bases from
a ``configs/examples/*.json`` config, replay with the reduced solver), taken
with the port's entry points: :func:`bench_model` and :func:`gravity` give
bench.py's scene, :func:`record_fom` records a full-order run
with ``sim/solver.py`` (trajectory, ``assembly_ST.npz``, ``<group>_p.npz``);
:func:`example_config` reads an example config with its paths pointed at a
recording and :func:`export_mesh` writes the recorded model's mesh where the
config looks for it; :func:`compute_constproj_bases` drives ``BasesConfig ->
NonlinearSnapshots -> ConstraintComponents`` on one group, with the
selection its ``interpolation_type`` names (``deim``, ``deim_block_form``,
or ``geom`` with the error in position space, as the JAX ``cli.py`` runs
them; the bases CLI runs it too) and :func:`build_bases_from_config`
stores its result; :func:`build_group_basis` does so on bench.py's config
(``pod_vectorized``, row DEIM); :func:`reduced_args` gives the reduced
solver's arguments for the bench's bases.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from animsnapbases_tpu_torch.bases.constraints import ConstraintComponents
from animsnapbases_tpu_torch.config.bases_config import BasesConfig
from animsnapbases_tpu_torch.config.sim_config import default_sim_args
from animsnapbases_tpu_torch.io.meshes import save_medit_mesh, save_obj
from animsnapbases_tpu_torch.snapshots.nonlinear import NonlinearSnapshots
from animsnapbases_tpu_torch.sim.solver import Solver


def bench_model(rows: int = 120):
    """bench.py's scene without the reference mesh (bench.py:73-109): the
    procedural cloth of ``rows`` x ``rows`` vertices (120 in bench.py),
    normalized, hung 20 units up, masses 10, the top cap above the 0.80
    quantile pinned, tris_strain (0.95-1.05) and edge_spring at wi = 1e4,
    floor on."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, F = cloth_model(rows, rows)
    V = V / float(rows)
    V[:, 2] += 0.05 * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    V[:, 1] += 20.0
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    top = np.where(model.positions[:, 1]
                   > np.quantile(model.positions[:, 1], 0.80))[0]
    for vi in top:
        model.fix(vi)
    return model


def gravity(model):
    """bench.py's external force: -9.81 x 10 along y on every vertex."""
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0
    return f


def record_fom(model, fext, record, frames: int, iterations: int, dt: float,
               damping: float, global_solve: str = "host", device=None):
    """Record ``frames`` steps of ``model`` under ``fext`` (bench.py:
    243-270): the S^T export and the p-snapshots under ``record`` (flushed
    at frame ``frames - 1``; ``record=None``: the positions only) ->
    (trajectory (frames, N, 3), the prepared solver)."""
    solver = Solver(global_solve=global_solve, device=device)
    solver.set_model(model)
    args = default_sim_args()
    args.dt = dt
    args.damping = damping
    solver.prepare(args)
    if record is not None:
        solver.store_assembly_matrices(record)
        solver.set_record_path(record)
        solver.set_store_p(True)
        solver.max_p_snapshots_num = frames - 1
    traj = solver.run_steps(fext, frames, num_iterations=iterations,
                            record=True)
    return traj, solver


def group_basis_config(record, gname: str, p: int, num_modes: int,
                       frames: int, work_dir: str) -> BasesConfig:
    """The bases config of bench.py:129-163 for one group's recording:
    ``pod_vectorized``, row DEIM, ``num_modes`` modes, the first
    ``frames`` frames, no weighting, standardization or orthogonalization."""
    elements = "_tris" if gname == "tris_strain" else "_edges"
    cfg = {
        "object": {"experiment_dir": work_dir + "/", "mesh": "bunny",
                   "volumetric": False, "experiment": "bench_" + gname,
                   "snap_format": ".off"},
        "vertexPos_bases": {"computeState": {"compute": False}},
        "constraintProj_bases": {
            "computeState": {"compute": True, "run_main": True,
                             "testingComputations": "_Release"},
            "constraintType": {"name": gname, "elements": elements,
                               "p_snaps_folder": "/x",
                               "assembly_file_name": "assembly_ST.npz",
                               "assembly_key": gname,
                               "snaps_pattern_full_p": "/t.npz",
                               "constrained_elements": "",
                               "rowSize": p},
            "snapshots": {"numFrames": frames, "frame_increment": 1,
                          "preAlignement": "_noAlignement",
                          "reduced_snaps_available": False},
            "basis_type": "pod_vectorized", "interpolation_type": "deim",
            "desired_num_components": num_modes, "bases_res_tol": 1e-20,
            "dim": 3, "max_element_per_geom_vert": 10,
            "rest_shape": "first", "massWeighted": "_nonWeighted",
            "standarized": "_nonStandarized", "supported": "_Global",
            "orthogonalized": "_nonOrthogonalized",
            "store_sing_val": False, "store_to_files": True,
            "run_tests": False, "visualize_geom_elements": False,
            "visualize_elements_at_bases_num": 0},
    }
    param = BasesConfig.from_dict(cfg, results_dir=os.path.join(work_dir,
                                                                "results"))
    param.constProj_input_snapshots_pattern = os.path.join(
        record, gname + "_p.npz")
    param.constProj_weightedSt = os.path.join(record, "assembly_ST.npz")
    param.ensure_dirs()
    return param


def _example_dict(json_path: str, work_dir: str, **overrides) -> dict:
    """The JSON of ``json_path`` with its experiment directory ``work_dir``
    and ``overrides`` in its ``constraintProj_bases`` section
    (``numFrames`` and ``frame_increment`` in its ``snapshots``)."""
    import json

    with open(json_path) as fp:
        cfg = json.load(fp)
    cfg["object"]["experiment_dir"] = work_dir + "/"
    cp = cfg["constraintProj_bases"]
    for key, value in overrides.items():
        if key in ("numFrames", "frame_increment"):
            cp["snapshots"][key] = value
        else:
            cp[key] = value
    return cfg


def example_config(json_path: str, record: str, work_dir: str,
                   **overrides) -> BasesConfig:
    """The bases config of ``json_path`` (a ``configs/examples/*.json``
    file) for the recording under ``record``: its snapshots, S^T and
    constrained-element files are the recording's, its outputs and mesh
    files lie under ``work_dir``.  ``overrides`` replace entries of its
    ``constraintProj_bases`` section (``numFrames`` and ``frame_increment``
    those of its ``snapshots``)."""
    cfg = _example_dict(json_path, work_dir, **overrides)
    param = BasesConfig.from_dict(cfg, results_dir=os.path.join(work_dir,
                                                                "results"))
    gname = param.constProj_name
    param.constProj_input_snapshots_pattern = os.path.join(
        record, gname + "_p.npz")
    param.constProj_weightedSt = os.path.join(record, "assembly_ST.npz")
    constrained = cfg["constraintProj_bases"]["constraintType"].get(
        "constrained_elements", "")
    if constrained:
        param.constProj_input_snaps_constrained_elements = os.path.join(
            record, constrained)
    param.ensure_dirs()
    return param


def example_config_file(json_path: str, record: str, work_dir: str,
                        path: str, **overrides) -> str:
    """:func:`example_config` as a JSON file at ``path`` for the bases CLI
    (``--config_file``; the sweep's workers): the recording is linked where
    the config's snapshot folder lies under ``work_dir``, so that the file
    alone names every input.  -> ``path``."""
    import json

    cfg = _example_dict(json_path, work_dir, **overrides)
    ct = cfg["constraintProj_bases"]["constraintType"]
    folder = os.path.normpath(os.path.join(
        work_dir, cfg["object"]["mesh"], cfg["object"].get("experiment", ""))
        + "/" + ct.get("p_snaps_folder", ""))
    if not os.path.lexists(folder):
        os.makedirs(os.path.dirname(folder), exist_ok=True)
        os.symlink(os.path.abspath(record), folder)
    if ct.get("snaps_pattern_full_p"):
        ct["snaps_pattern_full_p"] = f"/{ct['name']}_p.npz"
    with open(path, "w") as fp:
        json.dump(cfg, fp, indent=1)
    return path


def export_mesh(model, param: BasesConfig) -> None:
    """The model's rest mesh where ``param`` reads it: the surface as OBJ
    and, for a tet model, the tets and surface as MEDIT ``.mesh``."""
    os.makedirs(os.path.dirname(param.tri_mesh_file), exist_ok=True)
    save_obj(param.tri_mesh_file, model.positions, model.faces)
    if getattr(model, "elements", None) is not None and len(model.elements):
        save_medit_mesh(param.tet_mesh_file, model.positions,
                        tets=model.elements, tris=model.faces)


def _timed(timings, name, fn):
    t0 = time.perf_counter()
    out = fn()
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
    return out


def compute_constproj_bases(param: BasesConfig, device=None, timings=None):
    """One group's bases as ``param`` asks, not yet stored: its snapshots,
    components and post-processing, then the selection of its
    interpolation type (``deim``, ``deim_block_form``, or ``geom`` with
    the error in position space) -> the ConstraintComponents.
    ``timings`` (a dict) gathers the seconds of each stage."""
    t = timings if timings is not None else {}
    itype = param.constProj_bases_interpolation_type
    select = {
        "deim": lambda cc: cc.deim(),
        "deim_block_form": lambda cc: cc.deim_blocksForm(),
        "geom": lambda cc: cc.geom_block_form_utilizing_differential_operator(
            error_in_pos_space=True),
    }
    if itype not in select:
        raise ValueError(f"unknown interpolation type: {itype}")
    nl = NonlinearSnapshots(param)
    cc = ConstraintComponents(param, nl, device=device)
    nl.config()
    cc.config()
    _timed(t, "snapshots_prepare", nl.snapshots_prepare)
    _timed(t, "pod", cc.compute_components_store_singvalues)
    _timed(t, "post_process", cc.post_process_components)
    _timed(t, "deim", lambda: select[itype](cc))
    return cc


def build_bases_from_config(param: BasesConfig, basis_dir: str,
                            device=None, timings=None):
    """One group's bases (:func:`compute_constproj_bases`), stored and
    copied to ``basis_dir/<group>/basis.npz`` -> the ConstraintComponents.
    ``timings`` (a dict) gathers the seconds of each stage."""
    t = timings if timings is not None else {}
    cc = compute_constproj_bases(param, device=device, timings=t)
    npz = _timed(t, "store", cc.store_components_n_interpol_points)
    gdir = os.path.join(basis_dir, param.constProj_name)
    os.makedirs(gdir, exist_ok=True)
    shutil.copy(npz, os.path.join(gdir, "basis.npz"))
    return cc


def build_group_basis(record, gname: str, p: int, num_modes: int,
                      frames: int, work_dir: str, basis_dir: str,
                      device=None, timings=None):
    """One group's bases on bench.py's config (:func:`group_basis_config`)
    -> the ConstraintComponents (:func:`build_bases_from_config`)."""
    param = group_basis_config(record, gname, p, num_modes, frames, work_dir)
    return build_bases_from_config(param, basis_dir, device=device,
                                   timings=timings)


def build_bases(model, record, traj, work_dir: str, constr_modes: int,
                pos_modes: int, device=None, timings=None):
    """Both steps of bench.py:272-291 on a recording: each non-positional
    group's bases from the recording's first ``len(traj) - 1`` frames
    (:func:`build_group_basis`), under ``work_dir/bases``, and the position
    basis of ``traj`` (r = min(pos_modes, frames)) in
    ``work_dir/pos_basis.npz`` -> (basis_dir, pos_path, {group:
    ConstraintComponents}).  ``timings`` gathers the seconds of each stage,
    the position basis under "position_basis"."""
    from animsnapbases_tpu_torch.bases.position_reduction import (
        position_basis_from_trajectory,
        save_position_basis,
    )

    t = timings if timings is not None else {}
    basis_dir = os.path.join(work_dir, "bases")
    groups = {}
    for gname, g in model.groups.items():
        if gname == "positional":
            continue
        groups[gname] = build_group_basis(
            record, gname, g.p, constr_modes, len(traj) - 1,
            os.path.join(work_dir, "work"), basis_dir, device=device,
            timings=t)
    pos_path = os.path.join(work_dir, "pos_basis.npz")
    _timed(t, "position_basis", lambda: save_position_basis(
        pos_path, position_basis_from_trajectory(traj, pos_modes,
                                                 device=device)))
    return basis_dir, pos_path, groups


def reduced_args(basis_dir: str, pos_path: str, constr_modes: int,
                 pos_modes: int, dt: float, damping: float,
                 oversample: float = 4.0 / 3.0):
    """The reduced solver's arguments of bench.py:331-381: both groups
    reduced at ``constr_modes`` modes (``deim_pod_vectorized``), DEIM
    oversampled ``oversample`` times, ``pos_modes`` position modes."""
    args = default_sim_args()
    args.dt = dt
    args.damping = damping
    args.constraint_projection_basis_type = "deim_pod_vectorized"
    args.tri_strain_reduced = True
    args.tri_strain_num_components = constr_modes
    args.edge_spring_reduced = True
    args.edge_spring_num_components = constr_modes
    args.deim_oversample = oversample
    args.geom_interpolation_basis_dir = basis_dir
    args.geom_interpolation_basis_file = "basis.npz"
    args.position_reduced = True
    args.position_num_components = pos_modes
    args.position_basis_file = pos_path
    return args


def fom_deviation(positions: np.ndarray, fom: np.ndarray):
    """bench.py:485-490's statistic: |P - P_FOM| / max|P_FOM| per entry ->
    (mean, p99, max)."""
    d = np.abs(positions - fom) / np.abs(fom).max()
    return float(d.mean()), float(np.quantile(d, 0.99)), float(d.max())
