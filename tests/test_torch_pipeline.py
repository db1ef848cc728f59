"""The bench scene's whole pipeline in the PyTorch port (record -> bases ->
reduced solve, ``animsnapbases_tpu_torch.bases.pipeline``) against the JAX
package's (``bench._run_fom_and_bases_impl`` and ``build_reduced_solver``,
whose fused kernels stay off on the CPU), float64 on the CPU, at the size
``tests/test_bench_e2e.py`` runs bench.py: a 9x9 cloth, 12 frames, 6 modes
a group, 10 position modes.

Tolerances: the recordings to 1e-10 of the scene's extent (measured
2.7e-15), the bases as ``tests/test_torch_bases.py`` holds them (DEIM
picks equal or ties, the POD within the Gram method's rounding bound), the
reduced solve of each package on the same bases files to 1e-9 of the
extent (measured 1.4e-10) and their reduced-vs-FOM statistics to 1e-9.
The two pipelines end to end, each on its own bases: 1e-5 of the extent
(measured 1.1e-6).  That gap is the position basis's: its tail modes
(singular values below ~1e-6 of the first) are set by the Gram product's
rounding in each package (``chip_smoke.pod_bounds``), and the reduced solve
reads them.
"""

import os

import numpy as np
import pytest
import torch

import bench
import chip_smoke as cs
from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.ops.podlinalg import snapshot_pod as jax_pod
from animsnapbases_tpu_torch.bases.pipeline import (
    build_bases,
    fom_deviation,
    record_fom,
    reduced_args,
)
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

ROWS, FRAMES, CONSTR, POS = 9, 12, 6, 10


def small_mesh():
    V, F = jax_cloth(ROWS, ROWS)
    V = V / float(ROWS)
    V[:, 2] += 0.05 * V[:, 0]
    V = V - V.mean(axis=0)
    return (V / np.abs(V).max()).astype(np.float64), F.astype(np.int64), \
        "tiny-cloth"


def port_scene():
    return cs.bench_scene(DeformableModel,
                          lambda r, c: cloth_model(ROWS, ROWS))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("BENCH_DIR", str(tmp / "jax")),
                            ("FOM_FRAMES", FRAMES), ("POS_MODES", POS),
                            ("CONSTR_MODES", CONSTR),
                            ("load_mesh", small_mesh)):
            mp.setattr(bench, name, value)
        meta = bench.run_fom_and_bases()

        def jax_reduced(basis_dir, pos_path):
            solver, model = bench.build_reduced_solver(
                dict(meta, basis_dir=basis_dir, pos_path=pos_path), None)
            assert solver._resident is None
            solver.run_steps(bench.gravity(model), FRAMES,
                             num_iterations=bench.FOM_ITERS)
            return model.positions.copy()

        jax_end = jax_reduced(meta["basis_dir"], meta["pos_path"])
        model = port_scene()
        f = cs.gravity(model)
        record = str(tmp / "port" / "FOM")
        traj, _ = record_fom(model, f, record, FRAMES, bench.FOM_ITERS,
                             bench.DT, bench.DAMPING, device="cpu")
        basis_dir, pos_path, groups = build_bases(
            model, record, traj, str(tmp / "port"), CONSTR, POS,
            device="cpu")

        def port_reduced(basis_dir, pos_path):
            args = reduced_args(basis_dir, pos_path, min(30, CONSTR), POS,
                                bench.DT, bench.DAMPING)
            m = port_scene()
            s = AnimSnapBasesSolver(args, device="cpu", dtype=torch.float64)
            s.set_model(m)
            s.prepare(args)
            s.run_steps(f, FRAMES, num_iterations=bench.FOM_ITERS)
            return m.positions.copy()

        return {
            "meta": meta, "traj_jax": np.load(os.path.join(
                bench.BENCH_DIR, "traj.npy")),
            "jax_end": jax_end, "traj": traj, "record": record,
            "groups": groups, "basis_dir": basis_dir, "pos_path": pos_path,
            "port_end": port_reduced(basis_dir, pos_path),
            "jax_on_port": jax_reduced(basis_dir, pos_path),
            "port_on_jax": port_reduced(meta["basis_dir"], meta["pos_path"]),
        }


def test_recordings_match(pipelines):
    traj, traj_j = pipelines["traj"], pipelines["traj_jax"]
    extent = np.abs(traj_j).max()
    assert traj.shape == traj_j.shape == (FRAMES, ROWS * ROWS, 3)
    np.testing.assert_allclose(traj, traj_j, rtol=0, atol=1e-10 * extent)
    for g in ("tris_strain", "edge_spring"):
        a = np.load(os.path.join(pipelines["meta"]["record"], g + "_p.npz"))
        b = np.load(os.path.join(pipelines["record"], g + "_p.npz"))
        assert b.files == a.files == [str(i) for i in range(FRAMES)]
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=1e-10 * extent)


@pytest.mark.parametrize("gname", ["tris_strain", "edge_spring"])
def test_constraint_bases_match(pipelines, gname):
    a = np.load(os.path.join(pipelines["meta"]["basis_dir"], gname,
                             "basis.npz"))
    b = np.load(os.path.join(pipelines["basis_dir"], gname, "basis.npz"))
    assert sorted(b.files) == sorted(a.files)
    cc = pipelines["groups"][gname]
    R = np.stack([np.load(os.path.join(pipelines["meta"]["record"],
                                       gname + "_p.npz"))[str(i)]
                  for i in range(FRAMES - 1)])
    S = np.asarray(jax_pod(R.reshape(FRAMES - 1, -1).T)[1])
    ds, du = cs.pod_bounds(S, CONSTR)
    d_u = cs.sign_aligned_diff(a["components"], b["components"])
    assert (d_u <= du).all() and d_u[0] <= 1e-9
    assert (np.abs(cc.singVals[:CONSTR] - S[:CONSTR]) <= ds).all()
    ok, ties = cs.deim_picks_agree(a["components"], a["Pt"], b["Pt"], d_u)
    assert ok, ties
    np.testing.assert_array_equal(b["interpol_alpha_ranges"],
                                  a["interpol_alpha_ranges"])


def test_port_bases_read_the_jax_recording(pipelines, tmp_path):
    """The port's bases pipeline on the JAX package's recording
    (``assembly_ST.npz`` with its pickled scipy matrices, the frame-keyed
    ``<group>_p.npz``): the same snapshots as from its own recording, the
    same picks (or ties)."""
    from animsnapbases_tpu_torch.bases.pipeline import build_group_basis

    for gname, own in pipelines["groups"].items():
        cc = build_group_basis(pipelines["meta"]["record"], gname,
                               2 if gname == "tris_strain" else 1, CONSTR,
                               FRAMES - 1, str(tmp_path / "w"),
                               str(tmp_path / "b"), device="cpu")
        extent = np.abs(pipelines["traj_jax"]).max()
        np.testing.assert_allclose(cc.nonlinearSnapshots.snapTensor,
                                   own.nonlinearSnapshots.snapTensor,
                                   rtol=0, atol=1e-10 * extent)
        St = own.St.toarray()
        np.testing.assert_allclose(cc.St.toarray(), St, rtol=0,
                                   atol=1e-12 * np.abs(St).max())
        d_u = cs.sign_aligned_diff(own.comps, cc.comps)
        ok, ties = cs.deim_picks_agree(own.comps, own.geom_Pt, cc.geom_Pt,
                                       d_u)
        assert ok, ties


def test_position_bases_match(pipelines):
    a = np.load(pipelines["meta"]["pos_path"])["components"]
    b = np.load(pipelines["pos_path"])["components"]
    assert a.shape == b.shape == (POS, ROWS * ROWS, 3)
    for d in range(3):
        S = np.asarray(jax_pod(pipelines["traj_jax"][:, :, d].T)[1])
        _, du = cs.pod_bounds(S, POS)
        d_u = cs.sign_aligned_diff(a[:, :, d], b[:, :, d])
        assert (d_u <= du).all() and d_u[0] <= 1e-9


def test_reduced_solves_agree_on_the_same_bases(pipelines):
    """Each package's reduced solver reads the other's files: on the port's
    bases and on the JAX package's, the two solves agree to 1e-9 of the
    extent, and so do their reduced-vs-FOM statistics."""
    tail = pipelines["traj_jax"][-1]
    extent = np.abs(tail).max()
    np.testing.assert_allclose(pipelines["jax_on_port"],
                               pipelines["port_end"], rtol=0,
                               atol=1e-9 * extent)
    np.testing.assert_allclose(pipelines["port_on_jax"],
                               pipelines["jax_end"], rtol=0,
                               atol=1e-9 * extent)
    np.testing.assert_allclose(
        fom_deviation(pipelines["port_end"], pipelines["traj"][-1]),
        fom_deviation(pipelines["jax_on_port"], tail), rtol=0, atol=1e-9)
    assert np.isfinite(pipelines["port_end"]).all()


def test_pipelines_agree_end_to_end(pipelines):
    """Each pipeline on its own bases: within the position basis's rounding
    (see the module docstring), and near the recording."""
    tail = pipelines["traj_jax"][-1]
    extent = np.abs(tail).max()
    np.testing.assert_allclose(pipelines["port_end"], pipelines["jax_end"],
                               rtol=0, atol=1e-5 * extent)
    mean, p99, top = fom_deviation(pipelines["port_end"],
                                   pipelines["traj"][-1])
    assert top < 1e-3 and mean <= p99 <= top
