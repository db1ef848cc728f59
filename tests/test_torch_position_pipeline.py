"""The port's position workflow end to end (``cli.run_position_pipeline``,
``snapshots/pipeline.py``) against the JAX package, float64 on the CPU.

A 5x5 cloth, bent out of its plane so that no frame is planar (a planar
frame 0 takes the port's rank-2 Procrustes rule, ROADMAP Queue C, tested
in ``tests/test_torch_position_geometry.py``), is recorded by the JAX
full-order solver for 24 frames with its constraint bases; its frames are
written as ``pos_*.off`` with ``save_off``.  Both packages run the
position pipeline of one config on those files (global PCA, 8
components, ``_centered``, Volkwein masses, standardized, orthogonalized,
every 2nd of 10 frames): the aligned train and test ``.h5`` files equal,
the components within 1e-9 of their largest entry.  Then each package's
reduced solver serves 8 steps on its own PCA basis (the port on the plain
versions of kernels 1 and 5), the constraint bases shared, within 1e-9 of
the scene's extent (the velocities within that over dt).  The PCA basis
holds the rest shape, nonzero at the pinned vertices, so their 1e10 masses
make cond(Ar) ~1e9: the two solves part by ~4e-10 of the extent, on one
package's basis as on each its own.
"""

import os

import numpy as np
import pytest
import torch

from animsnapbases_tpu.cli import run_position_pipeline as jax_pipeline
from animsnapbases_tpu.config.bases_config import BasesConfig as JaxConfig
from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.io.h5anim import read_animation_h5 as jax_read
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver
from animsnapbases_tpu_torch.cli import run_position_pipeline
from animsnapbases_tpu_torch.config.bases_config import BasesConfig
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.io.h5anim import read_animation_h5
from animsnapbases_tpu_torch.io.meshes import save_off
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from animsnapbases_tpu_torch.snapshots.pipeline import (
    import_frames,
    sort_nicely,
)
from test_torch_fused_reduced import DAMPING, gravity

ROWS = 5
FRAMES = 24
ITERS = 6
STEPS = 8
K = 8
MODES = 4
TOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bent_model(cls, cloth):
    """The 5x5 cloth, tilted and bent out of its plane, hung 3 up, its left
    column pinned, tris_strain + edge_spring at wi = 1e4."""
    V, F = cloth(ROWS, ROWS)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0] + 0.2 * np.sin(V[:, 1])
    model = cls(V, F, masses=np.full(len(V), 10.0), floor_collision=True,
                init_height_shift=3.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    for vi in np.where(model.positions[:, 0] < 0.5)[0]:
        model.fix(vi)
    return model


def config(root, cls, results):
    cfg = {
        "object": {"experiment_dir": root + "/", "mesh": "cloth",
                   "volumetric": False, "experiment": "bent",
                   "snap_format": ".off"},
        "vertexPos_bases": {
            "computeState": {"compute": True,
                             "testingComputations": "_Release"},
            "snapshots": {"numFrames": 10, "frame_increment": 2,
                          "snaps_folder": "FOM", "anims_folder": "anims",
                          "preAlignement": "_centered",
                          "anim_folder_ready": False,
                          "visualize_aligned_animations": False,
                          "reduced_snaps_available": False},
            "rest_shape": "first", "massWeighted": "_Volkwein",
            "standarized": "_Standarized",
            "orthogonalized": "_Orthogonalized",
            "support": {"min_dist": 0.1, "max_dist": 0.5},
            "pca": {"compute": True, "numComponents": K,
                    "supported": "_Global", "store_sing_val": True},
            "splocs": {"compute": False},
            "store": True, "visualize": False, "run_tests": False},
        "constraintProj_bases": {"computeState": {"compute": False,
                                                  "run_main": True}},
    }
    return cls.from_dict(cfg, results_dir=results)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The recording, its .off sequence and constraint bases, and both
    packages' position pipelines on it."""
    from reduction_helpers import record_and_build_bases
    from test_sim_solver import sim_args

    tmp = tmp_path_factory.mktemp("pos_pipeline")
    basis_dir, _, traj = record_and_build_bases(
        tmp, lambda: bent_model(JaxModel, jax_cloth), sim_args(),
        frames=FRAMES, iters=ITERS, num_modes=MODES, pos_modes=K)
    faces = bent_model(DeformableModel, cloth_model).faces
    snaps = tmp / "cloth" / "bent" / "position_snapshots" / "FOM"
    snaps.mkdir(parents=True)
    for i, frame in enumerate(traj):
        save_off(str(snaps / f"pos_{i}.off"), frame, faces)
    port = config(str(tmp), BasesConfig, str(tmp / "port"))
    jax = config(str(tmp), JaxConfig, str(tmp / "jax"))
    return {"basis_dir": basis_dir, "traj": traj, "faces": faces,
            "port": (port, run_position_pipeline(port, device="cpu")),
            "jax": (jax, jax_pipeline(jax))}


def test_position_pipeline_matches_jax(both):
    (param, bases), (jparam, jbases) = both["port"], both["jax"]
    for name in ("train", "test"):
        attr = f"{name}_aligned_snapshots_animation_file"
        a = read_animation_h5(os.path.join(param.aligned_snapshots_directory,
                                           getattr(param, attr)))
        b = jax_read(os.path.join(jparam.aligned_snapshots_directory,
                                  getattr(jparam, attr)))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    assert bases.pos_snapshots.frs == 10
    assert bases.pos_snapshots.test_verts.shape[0] == 8
    top = np.abs(jbases.comps).max()
    np.testing.assert_allclose(bases.comps, jbases.comps, rtol=0,
                               atol=TOL * top)
    assert bases.is_utmu_orthogonal(atol=1e-8)
    out = param.vertPos_output_directory
    assert sorted(f for f in os.listdir(out) if f.endswith(".bin")) == sorted(
        f"q_pos_F10K{k}.bin" for k in range(1, K + 1))
    for f in ("components.h5", "function_timings.txt", "time_logs.txt"):
        assert os.path.exists(os.path.join(out, f)), f


def test_import_frames_equals_the_h5_of_the_sequence(both):
    """The in-memory import (what a recording on the card takes) gives the
    train .h5's frames before alignment."""
    param, _ = both["port"]
    traj = both["traj"]
    verts, tris, mean, scale = import_frames(traj[:20:2], both["faces"])
    b = read_animation_h5(os.path.join(param.input_animation_dir,
                                       param.train_snapshots_animation_file))
    np.testing.assert_array_equal(verts, b[0])
    np.testing.assert_array_equal(tris, b[1])
    assert b[2]["scale"] == scale
    files = ["pos_10.off", "pos_2.off", "pos_1.off"]
    sort_nicely(files)
    assert files == ["pos_1.off", "pos_2.off", "pos_10.off"]


def test_run_tests_names_a16(both, tmp_path):
    """``run_tests`` draws the PCA test figures (A16, now ported: it no
    longer raises): the figure and the singular-value CSV as the JAX
    pipeline writes them."""
    root = both["port"][0].snapshots_repo_dir.rstrip("/")
    out = {}
    for label, cls, run in (("port", BasesConfig, lambda p: (
            run_position_pipeline(p, device="cpu"))),
                            ("jax", JaxConfig, jax_pipeline)):
        param = config(root, cls, str(tmp_path / label))
        param.run_pca_tests = True
        run(param)
        out[label] = param.vertPos_output_directory
        assert os.path.exists(os.path.join(
            out[label], "posBases_pca_extraction_tests.png"))
    a, b = (np.loadtxt(os.path.join(out[k], "posBases_singvals.csv"),
                       delimiter=",", skiprows=1) for k in ("port", "jax"))
    np.testing.assert_allclose(a, b, rtol=TOL, atol=0)


def test_reduced_solve_on_the_pca_bases_matches_jax(both, tmp_path):
    from test_sim_solver import sim_args

    models = []
    for label, cls, solver_cls, cloth, kw in (
            ("jax", JaxModel, JaxSolver, jax_cloth, {"pallas_mode": "off"}),
            ("port", DeformableModel, AnimSnapBasesSolver, cloth_model,
             {"device": "cpu"})):
        pos_path = str(tmp_path / f"{label}_pos.npz")
        np.savez(pos_path, components=both[label][1].comps)
        args = sim_args(
            constraint_projection_basis_type="deim_pod_vectorized",
            tri_strain_reduced=True, tri_strain_num_components=MODES,
            edge_spring_reduced=True, edge_spring_num_components=MODES,
            geom_interpolation_basis_dir=both["basis_dir"],
            geom_interpolation_basis_file="basis.npz",
            position_reduced=True, position_num_components=K,
            position_basis_file=pos_path, damping=DAMPING)
        model = bent_model(cls, cloth)
        solver = solver_cls(args, **kw)
        solver.set_model(model)
        solver.prepare(args)
        f = gravity(model)
        for _ in range(STEPS // 2):
            solver.step(f, num_iterations=ITERS)
        solver.run_steps(f, STEPS // 2, num_iterations=ITERS)
        models.append(model)
    m_jax, m_port = models
    extent = np.abs(m_jax.positions).max()
    assert np.abs(m_jax.velocities).max() > 0.1          # the cloth moved
    np.testing.assert_allclose(m_port.positions, m_jax.positions, rtol=0,
                               atol=TOL * extent)
    # a velocity is a step's change of position over dt
    np.testing.assert_allclose(m_port.velocities, m_jax.velocities, rtol=0,
                               atol=TOL * extent / 0.016)
