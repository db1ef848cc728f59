"""The reference's per-group workflow as a whole, in both packages, float64
on the CPU, on a 9x9 cloth: record a full-order run, compute the bases of
one constraint group (``tris_strain``) from its example config
(``configs/examples/cloth_automated_geom_triStrainSubspace.json``, and the
same config with ``pca_blocks`` + ``deim_block_form``), replay with the
reduced solver, the positions full and ``edge_spring`` full (the dense
Cholesky), the group served under a block type.

The config is read without its standardization (see ``OVERRIDES``; the
standardized bases are held on sign-aligned modes).

Held: the recordings to 1e-10 of the scene's extent; the selections equal;
each package's solver on the other's bases files to 1e-9 of the extent
after 8 steps (both solve the same float64 systems from the same file);
the two workflows end to end, each on its own recording and bases, to
1e-6 of the extent.  That last gap is the POD's: both packages keep every
mode above 1e-12 of the first, whose span is the snapshots' range, but the
modes themselves (and with them the greedy's residuals and ``W``) are set
in the smallest ones by the Gram product's rounding
(``chip_smoke.pod_bounds``), as ``tests/test_torch_pipeline.py`` argues
for the position basis.  Measured: 1.4e-14 (geom) and 2.4e-14 (blocks)
of the extent end to end, 4e-15 to 1.2e-14 on one file.

Also what each reduction type does with a geom file (ROADMAP Queue C):
both packages read it the same way, including where that way is wrong.
"""

import copy
import json
import os
import shutil
import warnings

import numpy as np
import pytest

from animsnapbases_tpu.config.bases_config import BasesConfig as JaxConfig
from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.io.meshes import save_obj
from animsnapbases_tpu.sim import reduced as jred
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver
from animsnapbases_tpu.sim.solver import Solver as JaxFullSolver
from animsnapbases_tpu_torch.bases.pipeline import (
    build_bases_from_config,
    example_config,
    export_mesh,
    record_fom,
)
from animsnapbases_tpu_torch.sim import reduced as tred
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_sim_solver import sim_args
from test_torch_block_bases import components, one_thread  # noqa: F401
from test_torch_fused_reduced import DAMPING, gravity, small_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(
    REPO, "configs/examples/cloth_automated_geom_triStrainSubspace.json")
ROWS, FRAMES, ITERS, STEPS, K = 9, 16, 6, 8, 6
# without standardization: it adds the mean back to each POD mode, so the
# components (and the selections) follow each mode's free sign, which the
# two packages' eigensolvers choose differently
# (test_standardized_bases_differ_by_the_modes_signs)
OVERRIDES = {"numFrames": 7, "desired_num_components": K,
             "standarized": "_nonStandarized"}
# the block extraction at 3 blocks: 2 x 3 rank-1 deflations of the 6-rank
# standardized snapshots (7 frames less the first); past the rank its
# components are set by rounding, and so are the greedy's picks
KINDS = {"geom": {}, "blocks": {"basis_type": "pca_blocks",
                                "interpolation_type": "deim_block_form",
                                "desired_num_components": 3}}
SERVED = {"geom": "geom_pca_blocks_withSt", "blocks": "deim_pca_blocks"}


def jax_bases(record, work, basis_dir, model, **overrides):
    """The JAX package's bases CLI pipeline (``cli.run_constproj_pipeline``)
    on the same config as :func:`example_config`."""
    from animsnapbases_tpu.cli import run_constproj_pipeline

    with open(EXAMPLE) as fp:
        cfg = json.load(fp)
    cfg["object"]["experiment_dir"] = work + "/"
    cp = cfg["constraintProj_bases"]
    cp["run_tests"] = False
    for key, value in {**OVERRIDES, **overrides}.items():
        if key in ("numFrames", "frame_increment"):
            cp["snapshots"][key] = value
        else:
            cp[key] = value
    param = JaxConfig.from_dict(cfg, results_dir=os.path.join(work,
                                                              "results"))
    param.constProj_input_snapshots_pattern = os.path.join(
        record, "tris_strain_p.npz")
    param.constProj_weightedSt = os.path.join(record, "assembly_ST.npz")
    os.makedirs(os.path.dirname(param.tri_mesh_file), exist_ok=True)
    save_obj(param.tri_mesh_file, model.positions, model.faces)
    cc = run_constproj_pipeline(param)
    os.makedirs(os.path.join(basis_dir, "tris_strain"), exist_ok=True)
    shutil.copy(os.path.join(param.constProj_output_directory,
                             "components_interpol_alphas_interpol_verts_"
                             "interpol_alpha_ranges.npz"),
                os.path.join(basis_dir, "tris_strain", "basis.npz"))
    return cc


def jax_record(path):
    model = small_model(JaxModel, jax_cloth, ROWS, ROWS)
    s = JaxFullSolver()
    s.set_model(model)
    s.prepare(sim_args(damping=DAMPING))
    s.store_assembly_matrices(path)
    s.set_record_path(path)
    s.set_store_p(True)
    s.max_p_snapshots_num = FRAMES - 1
    f = gravity(model)
    traj = []
    for _ in range(FRAMES):
        s.step(f, num_iterations=ITERS)
        traj.append(model.positions.copy())
    return np.array(traj), model


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("workflow")
    out = {"jax": {}, "torch": {}}
    traj_j, m_j = jax_record(str(tmp / "jax" / "FOM"))
    model = small_model(DeformableModel, rows=ROWS, cols=ROWS)
    traj_t, _ = record_fom(model, gravity(model), str(tmp / "torch" / "FOM"),
                           FRAMES, ITERS, 0.016, DAMPING, device="cpu")
    out["traj"] = {"jax": traj_j, "torch": traj_t}
    out["record"] = str(tmp / "torch" / "FOM")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kind, overrides in KINDS.items():
            for pkg in ("jax", "torch"):
                record = str(tmp / pkg / "FOM")
                work = str(tmp / pkg / kind)
                bdir = str(tmp / pkg / kind / "bases")
                if pkg == "jax":
                    cc = jax_bases(record, work, bdir, m_j, **overrides)
                else:
                    param = example_config(EXAMPLE, record, work,
                                           **{**OVERRIDES, **overrides})
                    export_mesh(model, param)
                    cc = build_bases_from_config(param, bdir, device="cpu")
                out[pkg][kind] = (cc, bdir)
    return out


def serve(cls, bdir, kind, steps=STEPS):
    """The solver ``cls`` (either package's) on the bases under ``bdir``:
    tris_strain reduced under the block type of ``kind`` (at the config's
    component count), edge_spring and the positions full -> the positions
    after ``steps`` steps."""
    comps = KINDS[kind].get("desired_num_components", K)
    args = sim_args(constraint_projection_basis_type=SERVED[kind],
                    tri_strain_reduced=True,
                    tri_strain_num_components=comps,
                    edge_spring_reduced=False,
                    geom_interpolation_basis_dir=bdir,
                    geom_interpolation_basis_file="basis.npz",
                    position_reduced=False, damping=DAMPING)
    if cls is JaxSolver:
        model = small_model(JaxModel, jax_cloth, ROWS, ROWS)
        s = cls(args, pallas_mode="off")
    else:
        model = small_model(DeformableModel, rows=ROWS, cols=ROWS)
        s = cls(args, device="cpu")
    s.set_model(model)
    s.prepare(args)
    s.run_steps(gravity(model), steps, num_iterations=ITERS)
    return model.positions.copy()


def test_recordings_match(workflow):
    a, b = workflow["traj"]["jax"], workflow["traj"]["torch"]
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-10 * np.abs(a).max())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_selections_match(workflow, kind):
    (a, _), (b, _) = workflow["jax"][kind], workflow["torch"][kind]
    assert a.numComp == b.numComp > 0
    np.testing.assert_array_equal(b.geom_alpha, a.geom_alpha)
    np.testing.assert_array_equal(b.geom_Pt, a.geom_Pt)
    np.testing.assert_array_equal(b.geom_alpha_ranges, a.geom_alpha_ranges)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("files", ["jax", "torch"])
def test_each_package_serves_the_others_files(workflow, kind, files):
    """Both solvers on one package's block-form or geom file: 1e-9 of the
    extent after 8 steps."""
    bdir = workflow[files][kind][1]
    a = serve(JaxSolver, bdir, kind)
    b = serve(AnimSnapBasesSolver, bdir, kind)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9 * np.abs(a).max())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_workflows_agree_end_to_end(workflow, kind):
    """Record -> bases -> reduced solve, each package on its own files:
    within the POD's rounding (module docstring), and the reduced solve
    near the recording."""
    a = serve(JaxSolver, workflow["jax"][kind][1], kind)
    b = serve(AnimSnapBasesSolver, workflow["torch"][kind][1], kind)
    extent = np.abs(a).max()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * extent)
    fom = workflow["traj"]["torch"][STEPS - 1]
    assert np.abs(b - fom).max() < 0.1 * extent


def test_reduction_types_read_geom_files_as_jax_does(tmp_path):
    """What each reduction type does with a geom file, the same in both
    packages.  tris_strain (p = 2): the block types rebuild every row of
    the selected elements; ``deim_pod_vectorized`` takes the first
    ``alpha_range`` rows of Pt against as many elements, so that element
    j's row ``Pt[j] % p`` is paired with the basis row of element
    ``Pt[j] // p`` (the two lists part after the first p / 2 elements).
    verts_bending: the geom file's elements are vertex ids, which the
    block types use as constrained-vertex rows: out of range (IndexError)
    or another vertex's row."""
    cc = components("torch", tmp_path / "tris", "tris")
    cc.compute_pod_vectorized()
    cc.param.constProj_output_directory = str(tmp_path)
    cc.geom_block_form_utilizing_differential_operator(
        error_in_pos_space=True)
    npz = cc.store_components_n_interpol_points()
    from test_torch_block_bases import scene

    model, g = scene("tris")
    for rtype in ("deim_pod_vectorized", "geom_pca_blocks_withSt"):
        got = tred.prepare_reduced_group(g, rtype, 3, npz, model.n_verts)
        want = jred.prepare_reduced_group(g, rtype, 3, npz, model.n_verts)
        np.testing.assert_allclose(got[0].W, want[0].W, rtol=1e-12,
                                   atol=1e-12 * np.abs(want[0].W).max())
        for x, y in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(x, y)
        alphas, Pt = got[1], got[2]
        if rtype == "deim_pod_vectorized":
            assert len(Pt) == len(alphas)
            assert not np.array_equal(Pt // 2, alphas)
        else:
            np.testing.assert_array_equal(Pt // 2, np.repeat(alphas, 2))

    cc = components("torch", tmp_path / "verts", "verts")
    cc.compute_pod_vectorized()
    cc.param.constProj_output_directory = str(tmp_path)
    cc.geom_block_form_utilizing_differential_operator(
        error_in_pos_space=True)
    npz = cc.store_components_n_interpol_points()
    model, g = scene("verts")
    rows = len(g.data["indices"])
    assert np.asarray(cc.geom_alpha).max() >= rows
    for rtype in ("deim_pod_vectorized", "geom_pca_blocks_withSt"):
        for prepare in (tred.prepare_reduced_group,
                        jred.prepare_reduced_group):
            with pytest.raises(IndexError):
                prepare(g, rtype, copy.copy(cc.numComp), npz, model.n_verts)


def test_standardized_bases_differ_by_the_modes_signs(workflow, tmp_path):
    """With the config's standardization, the port's POD modes aligned in
    sign with the JAX package's before the post-processing (which adds the
    mean back) give the JAX package's components and geom selection."""
    from animsnapbases_tpu_torch.bases.constraints import (
        ConstraintComponents,
    )
    from animsnapbases_tpu_torch.snapshots.nonlinear import (
        NonlinearSnapshots,
    )

    model = small_model(DeformableModel, rows=ROWS, cols=ROWS)
    record = workflow["record"]
    std = {"standarized": "_Standarized"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_bases(record, str(tmp_path / "jax"),
                        str(tmp_path / "jax" / "bases"), model, **std)
        param = example_config(EXAMPLE, record, str(tmp_path / "torch"),
                               **{**OVERRIDES, **std})
        export_mesh(model, param)
        nl = NonlinearSnapshots(param)
        nl.config()
        nl.snapshots_prepare()
        cc = ConstraintComponents(param, nl, device="cpu")
        cc.config()
        cc.compute_components_store_singvalues()
        snaps = ref.nonlinearSnapshots
        raw = (ref.comps - snaps.mean[None]) * snaps.pre_scale_factor
        sign = np.where((raw * cc.comps).sum(axis=(1, 2)) < 0, -1.0, 1.0)
        cc.comps = cc.comps * sign[:, None, None]
        cc.post_process_components()
        cc.geom_block_form_utilizing_differential_operator(
            error_in_pos_space=True)
    np.testing.assert_allclose(cc.comps, ref.comps, rtol=0,
                               atol=1e-9 * np.abs(ref.comps).max())
    np.testing.assert_array_equal(cc.geom_alpha, ref.geom_alpha)
