"""Rank bodies of the port's sharded paths for ``tests/test_torch_parallel*.py``.

Each body runs on every rank of a gloo group of CPU processes started by
``animsnapbases_tpu_torch.parallel.launch.run_ranks`` and imports nothing
of JAX; rank 0 pickles its results (numpy arrays) to ``out``, which the
test compares with the port's single-process results and the JAX
package's in the pytest process.  The inputs are made here from seeds,
and the tests make the same ones with the same helpers.
"""

import os
import pickle

import numpy as np
import scipy.sparse
import torch

STEP_DT = 0.016


def cloth(rows=5, positional=False, pinned=False):
    """The small cloth of ``tests/test_parallel.py`` (5x5, strain and
    springs at wi = 1e4, floor on), optionally two positional constraints
    (vertices 0 and 4, wi = 1e6) or the flagship's pinned left side; the
    port's model."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    return build_cloth(cloth_model, DeformableModel, rows, positional,
                       pinned)


def build_cloth(cloth_model, DeformableModel, rows, positional, pinned):
    """:func:`cloth` on either package's classes."""
    V, F = cloth_model(rows, rows)
    V = V.copy()
    V[:, 2] += 0.1 * V[:, 0]
    m = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                        floor_collision=True, init_height_shift=3.0)
    m.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    m.add_edge_spring_constraint(wi=1e4)
    if positional:
        m.add_positional_constraint(0, wi=1e6)
        m.add_positional_constraint(rows - 1, wi=1e6)
    if pinned:
        m.compute_cloth_corner_indices()
        m.fix_surface_side_vertices("left")
    return m


def forces(model, B):
    """B gravity loads, sim b at (1 + 0.1 b) g."""
    f = np.zeros((B,) + model.positions.shape)
    f[:, :, 1] = -98.1 * (1.0 + 0.1 * np.arange(B))[:, None]
    return f


def target_shift(model):
    """The second step's positional targets: frame 0's moved 0.05 along z."""
    return np.asarray(model.positional_targets(0)) + np.array([0, 0, 0.05])


def bases_inputs():
    """The sharded bases compute's seeded inputs: a POD matrix (203, 12),
    a row-DEIM basis (203, 12, 3), a block-DEIM basis (203, 12, 3) with p =
    2 (row count not a multiple of the ranks) and a greedy residual (12,
    203, 3)."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((203, 12)) * np.geomspace(10.0, 0.1, 12)
    A = rng.standard_normal((203, 12, 3))
    Bk = rng.standard_normal((202, 12, 3))
    R0 = rng.standard_normal((12, 203, 3))
    return X, A, Bk, R0


def p_tensor(F=16, e=40, p=2, seed=3):
    """Low-rank constraint-projection snapshots (F, e*p, 3) with noise."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, F)
    modes = rng.normal(size=(4, e * p, 3))
    w = np.stack([np.sin(2 * np.pi * (k + 1) * t + rng.uniform(0, 1))
                  for k in range(4)])
    X = np.einsum("kf,knd->fnd", w, modes)
    return X + 0.01 * rng.normal(size=X.shape)


def cc_config(root, F, K, p=2):
    """A pod_vectorized + row-DEIM config of ``p_tensor``'s group."""
    return {
        "object": {"experiment_dir": str(root) + "/", "mesh": "m",
                   "volumetric": False, "experiment": "e",
                   "snap_format": ".off"},
        "vertexPos_bases": {"computeState": {"compute": False}},
        "constraintProj_bases": {
            "computeState": {"compute": True, "run_main": True,
                             "testingComputations": "_Release"},
            "constraintType": {"name": "tris_strain", "elements": "_tris",
                               "p_snaps_folder": "/x",
                               "assembly_file_name": "assembly_ST.npz",
                               "assembly_key": "tris_strain",
                               "snaps_pattern_full_p": "/t.npz",
                               "constrained_elements": "", "rowSize": p},
            "snapshots": {"numFrames": F, "frame_increment": 1,
                          "preAlignement": "_noAlignement",
                          "reduced_snaps_available": False},
            "basis_type": "pod_vectorized", "interpolation_type": "deim",
            "desired_num_components": K, "bases_res_tol": 1e-20, "dim": 3,
            "max_element_per_geom_vert": 100, "rest_shape": "first",
            "massWeighted": "_nonWeighted",
            "standarized": "_nonStandarized", "supported": "_Global",
            "orthogonalized": "_nonOrthogonalized",
            "store_sing_val": False, "store_to_files": False,
            "run_tests": False, "visualize_geom_elements": False,
            "visualize_elements_at_bases_num": 0},
    }


def constraint_components(root, X, K, shards, block=False, p=2):
    """The port's ConstraintComponents on X with ``device_mesh_shards`` =
    ``shards``: the POD, post-processing and the row (or block) DEIM ->
    (comps, singular values, Pt)."""
    from animsnapbases_tpu_torch.bases.constraints import (
        ConstraintComponents,
    )
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from animsnapbases_tpu_torch.snapshots.nonlinear import (
        NonlinearSnapshots,
    )

    cfg = cc_config(root, X.shape[0], K, p)
    if block:
        cfg["constraintProj_bases"]["interpolation_type"] = "deim_block_form"
    param = BasesConfig.from_dict(cfg, results_dir=os.path.join(root, "r"))
    param.device_mesh_shards = shards
    os.makedirs(param.constProj_output_directory, exist_ok=True)
    nl = NonlinearSnapshots(param)
    nl.config()
    nl.snapTensor = X.copy()
    nl.test_snapTensor = X.copy()
    nl.num_constained_elements = X.shape[1] // p
    nl.frs = X.shape[0]
    cc = ConstraintComponents(param, nl, device="cpu")
    cc.St = scipy.sparse.identity(X.shape[1], format="csr")
    cc.compute_components_store_singvalues()
    cc.post_process_components()
    if block:
        cc.deim_blocksForm(device=True)
    else:
        cc.deim()
    return cc.comps, cc.singVals, cc.geom_Pt, cc.pod_mesh is not None


def synthetic_solver(rows=8, K=4, r=6, block=False, extra=None,
                     **switches):
    """The port's solver of the pinned cloth on synthetic bases (fully
    reduced unless ``extra``, sim args, says otherwise), on the CPU in
    float64, ``switches`` set before a second prepare."""
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = cloth(rows, pinned=True)
    solver = synthetic_reduced_solver(model, K=K, r=r, device="cpu",
                                      block=block, extra_args=extra)
    if switches:
        for k, v in switches.items():
            setattr(solver, k, v)
        solver.prepare(solver.args)
    return solver, model


def batch_inputs(model, B):
    """B sims from rest, each its own load and a small spread of
    velocities."""
    pos = np.repeat(model.positions[None], B, axis=0)
    vel = np.zeros_like(pos)
    vel[:, :, 2] = 0.01 * np.arange(B)[:, None]
    return pos, vel, forces(model, B)


def paths(rank, world, out, names):
    """The bodies ``names`` (of :data:`BODIES`) in turn; rank 0 pickles
    their merged results to ``out``."""
    res = {}
    for name in names:
        res.update(BODIES[name](rank, world, out))
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


def fom_paths(rank, world, out):
    """The full-order and bases paths on a gloo group of ``world`` CPU
    ranks: the ensemble step over ("data",), the element-sharded step over
    ("model",) (dense, with positional constraints and per-call targets;
    and CG), at world 4 the data-parallel x element-sharded step on a 2x2
    mesh, the sharded POD, DEIM scans, greedy extraction and constraint
    bases."""
    from animsnapbases_tpu_torch.bases import greedy
    from animsnapbases_tpu_torch.ops.deim_scan import deim_blocks, deim_rows
    from animsnapbases_tpu_torch.ops.podlinalg import snapshot_pod_sharded
    from animsnapbases_tpu_torch.parallel import (
        build_device_mesh,
        make_element_sharded_step,
        make_ensemble_step,
    )
    from animsnapbases_tpu_torch.parallel.collectives import gather_blocks
    from animsnapbases_tpu_torch.sim.solver import Solver

    data = build_device_mesh((world,), ("data",), "cpu")
    model_axis = build_device_mesh((world,), ("model",), "cpu")
    res = {}

    m = cloth()
    B = 2 * world
    step, shard = make_ensemble_step(m, STEP_DT, data, device="cpu")
    pos, vel, fs = batch_inputs(m, B)
    p, v = step(shard(pos), shard(vel), shard(fs))
    p, v = step(p, v, shard(fs))
    res["ensemble"] = gather_blocks(p, B, data, "data").numpy()

    m = cloth(positional=True)
    step = make_element_sharded_step(m, STEP_DT, model_axis,
                                     num_iterations=4, device="cpu")
    f = torch.as_tensor(forces(m, 1)[0])
    q, v = step(m.positions, np.zeros_like(m.positions), f)
    q2, _ = step(q, v, f, targets=target_shift(m))
    res["element"] = (q.numpy(), q2.numpy())

    limit = Solver.DENSE_LIMIT
    Solver.DENSE_LIMIT = 0                 # the device CG
    try:
        m = cloth(8, pinned=True)
        step = make_element_sharded_step(m, STEP_DT, model_axis,
                                         num_iterations=4, device="cpu")
        f = forces(m, 1)[0]
        q, v = step(m.positions, np.zeros_like(m.positions), f)
        q, _ = step(q, v, f)
        res["element_cg"] = q.numpy()
    finally:
        Solver.DENSE_LIMIT = limit

    if world == 4:
        mesh = build_device_mesh((2, 2), ("data", "model"), "cpu")
        m = cloth()
        inner = make_element_sharded_step(m, STEP_DT, mesh,
                                          num_iterations=2, device="cpu")
        b = mesh.get_local_rank(0)
        f = forces(m, 2)[b]
        q, _ = inner(m.positions, np.zeros_like(m.positions), f)
        res["dp_tp"] = gather_blocks(q[None], 2, mesh, "data").numpy()

    X, A, Bk, R0 = bases_inputs()
    U, s, Vt = snapshot_pod_sharded(X, model_axis, device="cpu")
    res["pod"] = (U.numpy(), s.numpy(), Vt.numpy())
    res["deim_rows"] = deim_rows(A, device="cpu",
                                 mesh=model_axis)[0].numpy()
    res["deim_blocks"] = deim_blocks(Bk, 2, device="cpu",
                                     mesh=model_axis).numpy()
    out_g = greedy.extract_global(torch.as_tensor(R0), 9, mesh=model_axis)
    res["greedy"] = tuple(x.numpy() for x in out_g)
    root = os.path.join(os.path.dirname(out), f"cc_rank{rank}")
    Xp = p_tensor()
    res["cc"] = constraint_components(root, Xp, 10, world)
    res["cc_block"] = constraint_components(root + "b", Xp, 5, world,
                                            block=True)
    return res


def serving_paths(rank, world, out, rows=8, steps=5, iters=4):
    """``make_batched_run`` and ``make_batched_step`` with ``mesh=`` over
    ("data",), 2 sims a rank: the resident route and the large-model route
    (``CHUNKED_TIER1_MIN_VERTS = 0``, with a sim slammed into the floor so
    that its rank's kernel 5 exits first and the ranks must agree), per-sim
    target timelines split with the batch, and the not-fully-reduced route
    (a full edge_spring group) -> (positions, path) each."""
    from animsnapbases_tpu_torch.parallel import build_device_mesh

    data = build_device_mesh((world,), ("data",), "cpu")
    B = 2 * world
    res = {}
    for label, switches in (("resident", {}),
                            ("chunked", {"CHUNKED_TIER1_MIN_VERTS": 0})):
        solver, m = synthetic_solver(rows, **switches)
        pos, vel, fs = batch_inputs(m, B)
        fs[-1] *= 40.0
        p, v = solver.make_batched_run(data)(pos, vel, fs, steps,
                                             num_iterations=iters)
        res[label] = (p, v, solver._last_batched_path)
        p, _ = solver.make_batched_step(data)(pos, vel, fs, iters)
        res[label + "_step"] = (p, solver._last_batched_path)
    solver, m = synthetic_solver(rows)
    pos, vel, fs = batch_inputs(m, B)
    T = 6
    tl = np.repeat(np.asarray(m.positional_targets(0))[None, None],
                   B, axis=0).repeat(T, axis=1)
    tl[:, :, :, 2] += 0.01 * np.arange(B)[:, None, None] * np.arange(
        T)[None, :, None]
    p, _ = solver.make_batched_run(data)(pos, vel, fs, steps,
                                         num_iterations=iters,
                                         targets_seq=tl)
    res["per_sim"] = (p, tl, solver._last_batched_path)
    solver, m = synthetic_solver(rows, extra={"edge_spring_reduced": False})
    pos, vel, fs = batch_inputs(m, B)
    p, _ = solver.make_batched_run(data)(pos, vel, fs, 2,
                                         num_iterations=iters)
    res["full"] = (p, solver._last_batched_path)
    return res


def tp_paths(rank, world, out, steps=3, iters=6):
    """``make_tp_reduced_step`` over ("model",) on the row-form and the
    block-form synthetic solvers, ``steps`` steps from rest, the last with
    per-call targets."""
    from animsnapbases_tpu_torch.parallel import (
        build_device_mesh,
        make_tp_reduced_step,
    )

    mesh = build_device_mesh((world,), ("model",), "cpu")
    res = {}
    for label, block in (("row", False), ("block", True)):
        solver, m = synthetic_solver(10, block=block)
        step = make_tp_reduced_step(solver, mesh)
        f = forces(m, 1)[0]
        q, v = m.positions, np.zeros_like(m.positions)
        for _ in range(steps):
            q, v = step(q, v, f, num_iterations=iters)
        res[label] = (q.numpy(), v.numpy())
    return res


BODIES = {"fom": fom_paths, "serving": serving_paths, "tp": tp_paths}


def run(names, world, tmp_path):
    """The bodies ``names`` on ``world`` CPU ranks (one torch thread each,
    a 240 s limit on the ranks and on each collective) -> rank 0's
    results."""
    from animsnapbases_tpu_torch.parallel.launch import run_ranks

    out = str(tmp_path / f"{'_'.join(names)}_{world}.pkl")
    run_ranks(world, paths, (out, tuple(names)), timeout=240.0, threads=1)
    with open(out, "rb") as f:
        return pickle.load(f)


def fail_on_rank_1(rank, world):
    """A rank body whose rank 1 raises before the closing barrier."""
    if rank == 1:
        raise ValueError("rank 1 fails")


def hang_on_rank_1(rank, world, seconds):
    """A rank body whose rank 1 sleeps past every limit."""
    import time

    if rank == 1:
        time.sleep(seconds)
