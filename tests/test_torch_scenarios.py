"""The scripted scenarios, the model API they call, the mesh helpers, the
reduced replay and the checkpoints, held against the JAX package on the
CPU in float64 (``animsnapbases_tpu_torch/demos/scenarios.py``,
``sim/model.py``, ``geometry/mesh.py``, ``sim/checkpoint.py``): the same
inputs through both, small scenes (a 6x6 or 8x8 cloth, ``bar_model(8, 2,
2)``), torch on one thread, ``args.mesh_data_dir`` a temporary
directory."""

import os

import numpy as np
import pytest
import torch

from animsnapbases_tpu.config.sim_config import SimConfig as JaxConfig
from animsnapbases_tpu.demos import scenarios as jax_scen
from animsnapbases_tpu_torch.config.sim_config import SimConfig
from animsnapbases_tpu_torch.demos import scenarios as scen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "demos", "testing.json")
EXTENT_TOL = 1e-8
# after a floor contact (a clamp that branches on rounding): the card's
# CPU_DEVIATION of chip_smoke.py
CONTACT_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_args(tmp_path, jax=False, cloth=6, **overrides):
    """testing.json with its systems cut to a ``cloth`` x ``cloth`` cloth
    and an 8x2x2 bar, 4 iterations a step, outputs and mesh directory
    under ``tmp_path`` -> (params, args) of the port, or of the JAX
    package with ``jax``."""
    params = (JaxConfig if jax else SimConfig)(CONFIG)
    params.system_params["system"]["Cloth"] = {"cloth_width": cloth,
                                               "cloth_height": cloth}
    params.system_params["system"]["Bar"] = {"bar_width": 8, "bar_height": 2,
                                             "bar_depth": 2}
    args = params.build_args("Cloth")
    args.output_dir = str(tmp_path / ("jax" if jax else "port"))
    args.mesh_data_dir = str(tmp_path)
    args.solver_iterations = 4
    for k, v in overrides.items():
        setattr(args, k, v)
    return params, args


def both(tmp_path, name, max_frames, record=True, positions=True, **kw):
    """``name`` run in both packages to ``max_frames`` -> (JAX driver,
    port driver)."""
    out = []
    for jax in (True, False):
        params, args = small_args(tmp_path, jax=jax, **kw)
        build = jax_scen.build_scenario if jax else scen.build_scenario
        extra = {} if jax else {"device": "cpu"}
        d = build(name, args, record_fom_info=record, params=params,
                  record_positions=positions, **extra)
        d.run(max_frames=max_frames)
        out.append(d)
    return out


def assert_npz_close(a_path, b_path, tol):
    a = np.load(a_path, allow_pickle=True)
    b = np.load(b_path, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        x, y = a[k], b[k]
        if x.dtype == object:
            x, y = x.item().toarray(), y.item().toarray()
        scale = max(float(np.abs(x).max()) if x.size else 0.0, 1e-300)
        assert x.shape == y.shape, k
        if x.size:
            assert float(np.abs(x - y).max()) <= tol * scale, (a_path, k)


# ---------------------------------------------------------------------------
# the model API and the mesh helpers
# ---------------------------------------------------------------------------

def _models(V, F, T=None):
    from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    masses = np.full(len(V), 10.0)
    return (JaxModel(V, F, elements=T, masses=masses),
            DeformableModel(V, F, elements=T, masses=masses))


def _plain(v):
    """A group's data entry as comparable values (lists element-wise)."""
    if isinstance(v, (list, tuple)):
        return [None if x is None else _plain(x) for x in v]
    return np.asarray(v).copy()


def _assert_equal(a, b, key):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), key
        for x, y in zip(a, b):
            if x is None:
                assert y is None, key
            else:
                _assert_equal(x, y, key)
    else:
        np.testing.assert_array_equal(a, b, err_msg=key)


def _model_state(m):
    pos = m.groups.get("positional")
    return {"fixed": np.asarray(m.fixed_flags).copy(),
            "mass": np.asarray(m.mass).copy(),
            "picked": np.asarray(m.picked_vert).copy(),
            "velocities": np.asarray(m.velocities).copy(),
            "positional": (None if pos is None else
                           {k: _plain(v) for k, v in pos.data.items()}),
            "positional_list": [(c["vi"], c["wi"], c["motion_type"])
                                for c in m._positional],
            "groups": sorted(m.groups),
            "bending": (list(m.groups["verts_bending"].data["indices"])
                        if "verts_bending" in m.groups else [])}


def _assert_same_state(a, b):
    for key in ("fixed", "mass", "picked", "velocities"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["positional_list"] == b["positional_list"]
    assert a["groups"] == b["groups"] and a["bending"] == b["bending"]
    if a["positional"] is None:
        assert b["positional"] is None
    else:
        assert sorted(a["positional"]) == sorted(b["positional"])
        for k, v in a["positional"].items():
            _assert_equal(v, b["positional"][k], k)


@pytest.mark.parametrize("kind", ["cloth", "bar"])
def test_model_api_matches_jax(kind):
    """Every method the scenarios and the interactive handlers call leaves
    fixed_flags, mass, picked_vert, the velocities and the positional
    group as the JAX methods do, step by step."""
    from animsnapbases_tpu_torch.geometry.procedural import (
        bar_model,
        cloth_model,
    )

    if kind == "cloth":
        V, F = cloth_model(6, 6)
        T = None
    else:
        V, T, F, _ = bar_model(8, 2, 2)
    jm, pm = _models(V, F, T)
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=jm.positions.shape)
    shift = rng.normal(size=(5, 3))
    steps = [
        lambda m: m.compute_cloth_corner_indices(),
        lambda m: m.fix_surface_side_vertices(side="top"),
        lambda m: m.fix_surface_side_vertices(side="left"),
        lambda m: m.release_surface_side_vertices(side="top"),
        lambda m: m.release_surface_side_vertices(side="bottom"),
        lambda m: m.unfix(3),
        lambda m: m.toggle_fixed(4),
        lambda m: m.toggle_fixed(4, mass_when_unfixed=2.5),
        lambda m: m.toggle_picked(5),
        lambda m: m.toggle_picked(6),
        lambda m: m.toggle_picked(5),
        lambda m: setattr(m, "velocities", v0.copy()),
        lambda m: m.immobilize(),
        lambda m: m.add_positional_constraint(2, 1e8),
        lambda m: m.add_positional_constraint(
            7, 1e9, motion_type="user_defined", frame_shift=shift),
        lambda m: m.remove_positional_constraint(2),
        lambda m: m.add_edge_spring_constraint(1e5),
        lambda m: m.add_vertex_bending_constraint(0.5),
        lambda m: m.fix_side_vertices(side="right", axis=1),
        lambda m: m.remove_positional_constraint(7),
        lambda m: m.reset_constraints_attributes(),
    ]
    for i, step in enumerate(steps):
        step(jm)
        step(pm)
        _assert_same_state(_model_state(jm), _model_state(pm))
        for j in range(len(V)):
            assert jm.is_fixed(j) == pm.is_fixed(j), (i, j)
    assert pm.count_edges() == jm.count_edges()
    assert pm.count_edges(F[:3]) == jm.count_edges(F[:3])
    np.testing.assert_array_equal(pm.mass_init, jm.mass_init)


def test_mesh_helpers_match_jax():
    """``vertex_normals``, ``decimate_to_face_ratio``, ``padded_incidence``
    and ``vertex_star_edges`` against the JAX functions."""
    from animsnapbases_tpu.geometry import mesh as jax_mesh
    from animsnapbases_tpu_torch.geometry import mesh
    from animsnapbases_tpu_torch.geometry.procedural import (
        bar_model,
        cloth_model,
    )

    V, F = cloth_model(9, 7)
    V = V + 0.1 * np.random.default_rng(1).normal(size=V.shape)
    np.testing.assert_allclose(mesh.vertex_normals(V, F),
                               jax_mesh.vertex_normals(V, F), rtol=0,
                               atol=1e-14)
    # a vertex of no face gets a zero normal
    Vx = np.vstack([V, [[5.0, 5.0, 5.0]]])
    assert np.all(mesh.vertex_normals(Vx, F)[-1] == 0)
    for ratio in (0.3, 0.6, 1.5):
        got = mesh.decimate_to_face_ratio(V, F, ratio)
        want = jax_mesh.decimate_to_face_ratio(V, F, ratio)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-14)
        np.testing.assert_array_equal(got[1], want[1])
    _, T, Fb, _ = bar_model(4, 3, 2)
    for elements in (F, T, mesh.unique_edges(F)):
        for a, b in zip(mesh.padded_incidence(len(V) + 40, elements),
                        jax_mesh.padded_incidence(len(V) + 40, elements)):
            np.testing.assert_array_equal(a, b)
    got = mesh.vertex_star_edges(len(V), F)
    want = jax_mesh.vertex_star_edges(len(V), F)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_recording_subpath_matches_jax(tmp_path):
    """The recording path grammar, with and without reduction tags."""
    from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
    from animsnapbases_tpu_torch.geometry.procedural import bar_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, T, F, _ = bar_model(8, 2, 2)
    cases = [{}, {"constraint_projection_basis_type": "deim_pod_vectorized",
                  "tri_strain_reduced": True, "tri_strain_num_components": 7,
                  "edge_spring_reduced": True,
                  "edge_spring_num_components": 9},
             {"tet_strain_constraint": True, "tet_deformation_constraint": True,
              "constraint_projection_basis_type": "deim_pca_blocks",
              "tet_deformation_reduced": True,
              "tet_deformation_num_components": 5}]
    for over in cases:
        got = []
        for jax, Model, mod in ((True, JaxModel, jax_scen),
                                (False, DeformableModel, scen)):
            _, args = small_args(tmp_path, jax=jax, **over)
            m = Model(V, F, elements=T)
            mod.add_configured_constraints(m, args)
            got.append(mod.recording_subpath(args, m, "bar", "exp"))
        assert got[0] == got[1], over


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------

def test_every_scenario_constructs_as_in_jax(tmp_path):
    """All nine entries construct with the JAX scenario's stop frame; the
    gravity falls take the bar when ``mesh_data_dir`` holds no mesh."""
    assert sorted(scen.SCENARIOS) == sorted(jax_scen.SCENARIOS)
    for name in scen.SCENARIOS:
        params, args = small_args(tmp_path)
        d = scen.build_scenario(name, args, params=params, device="cpu")
        jparams, jargs = small_args(tmp_path, jax=True)
        jd = jax_scen.build_scenario(name, jargs, params=jparams)
        assert (d.stop_frame, d.object_name, d.experiment) == (
            jd.stop_frame, jd.object_name, jd.experiment), name
    with pytest.raises(ValueError, match="unknown scenario"):
        scen.build_scenario("nope", args)
    params, args = small_args(tmp_path)
    d = scen.build_scenario("bunny_gFall", args, params=params, device="cpu")
    V, F, T = d.build_geometry(args)
    assert len(T) and V.shape == (10 * 5 * 5, 3)


@pytest.mark.parametrize("name,frames", [
    ("cloth_automated_bend_spring_strain", 24),
    ("bar_automated_deformationgradient", 44)])
def test_scenario_matches_jax(tmp_path, name, frames):
    """A scenario run past its first event: the trajectories within 1e-8
    of the extent, the recorded ``*_p.npz`` and assembly files within 1e-8,
    the same ``.off`` files and mesh exports."""
    kw = {}
    if name.startswith("bar"):
        kw = dict(tet_deformation_constraint=True,
                  vert_bending_constraint=False, edge_constraint=False,
                  tri_strain_constraint=False,
                  deformation_gradient_constraint_wi=1e6)
    jd, pd = both(tmp_path, name, frames, cloth=8, **kw)
    A, P = np.array(jd.trajectory), np.array(pd.trajectory)
    assert A.shape == P.shape == (frames, len(jd.model.positions), 3)
    assert float(np.abs(A - P).max()) <= EXTENT_TOL * float(np.abs(A).max())
    np.testing.assert_array_equal(pd.model.fixed_flags, jd.model.fixed_flags)
    assert os.path.relpath(pd.record_path, pd.output_path) == os.path.relpath(
        jd.record_path, jd.output_path)
    files = sorted(os.listdir(jd.record_path))
    assert files == sorted(os.listdir(pd.record_path))
    assert any(f.endswith("_p.npz") for f in files)
    for f in files:
        assert_npz_close(os.path.join(jd.record_path, f),
                         os.path.join(pd.record_path, f), EXTENT_TOL)
    assert sorted(os.listdir(pd.pos_dir)) == sorted(os.listdir(jd.pos_dir))
    obj = os.path.join(pd.object_name, pd.object_name)
    assert os.path.exists(os.path.join(pd.output_path, obj + ".obj"))
    if name.startswith("bar"):
        assert os.path.exists(os.path.join(pd.output_path, obj + ".mesh"))
        # the left side released at frame 40
        left = np.argsort(pd.model.init_positions[:, 0])[:4]
        assert not pd.model.fixed_flags[left].any()


def test_chunked_replay_matches_per_frame(tmp_path):
    """One ``run_steps(record=True)`` call per event gap reproduces the
    per-frame loop: positions, recorded p-snapshots, exported frames."""
    def drive(sub, chunked):
        params, args = small_args(tmp_path / sub, edge_constraint=True,
                                  vert_bending_constraint=False)
        d = scen.build_scenario("cloth_automated_strain", args,
                                record_fom_info=True, params=params,
                                device="cpu")
        d.record_positions = True
        d.run(max_frames=26, chunked=chunked)
        return d

    a = drive("per_frame", chunked=False)
    b = drive("chunked", chunked=True)
    assert len(a.trajectory) == len(b.trajectory) == 26
    np.testing.assert_allclose(np.array(b.trajectory),
                               np.array(a.trajectory), atol=1e-8)
    assert_npz_close(os.path.join(a.record_path, "tris_strain_p.npz"),
                     os.path.join(b.record_path, "tris_strain_p.npz"), 1e-8)
    fa, fb = sorted(os.listdir(a.pos_dir)), sorted(os.listdir(b.pos_dir))
    assert fa == fb and len(fa) == 26


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_replay_randomized_schedule(tmp_path, seed):
    """A seeded random fix/release schedule: the chunked driver against
    the per-frame loop, and against the JAX driver on the same
    schedule."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model

    rng = np.random.default_rng(seed)
    events = sorted(rng.choice(np.arange(2, 28), size=4, replace=False))

    def geometry(a):
        V, F = cloth_model(6, 6)
        return V, F, None

    def setup(d):
        d.model.compute_cloth_corner_indices()
        d.model.fix_surface_side_vertices("left")

    def schedule():
        s = {"setup": setup}
        for i, ev in enumerate(events):
            side = ("fix_surface_side_vertices" if i % 2 == 0
                    else "release_surface_side_vertices")
            s[int(ev)] = (lambda d, side=side: getattr(d.model, side)(
                "right"))
        return s

    def build(sub, chunked, jax=False):
        params, args = small_args(tmp_path / f"{sub}{seed}", jax=jax,
                                  edge_constraint=True,
                                  vert_bending_constraint=False)
        if jax:
            drv = jax_scen.ScenarioDriver(args, "fuzz", "fuzz", geometry,
                                          schedule(), stop_frame=30)
        else:
            drv = scen.ScenarioDriver(args, "fuzz", "fuzz", geometry,
                                      schedule(), stop_frame=30,
                                      device="cpu")
        drv.run(chunked=chunked)
        return np.array(drv.trajectory)

    a = build("pf", chunked=False)
    b = build("ch", chunked=True)
    j = build("jax", chunked=True, jax=True)
    assert len(a) == len(b) == len(j) == 30
    np.testing.assert_allclose(b, a, atol=1e-8)
    assert float(np.abs(b - j).max()) <= EXTENT_TOL * float(np.abs(j).max())


def test_record_screenshots_exports_pngs(tmp_path):
    """``record_screenshots`` renders one PNG per simulated frame."""
    params, args = small_args(tmp_path, vert_bending_constraint=False)
    d = scen.build_scenario("cloth_automated_strain", args, params=params,
                            record_screenshots=True, device="cpu")
    d.run(max_frames=3)
    pngs = sorted(os.listdir(d.shots_dir))
    assert pngs == [f"screenshot_{i:04d}.png" for i in range(3)]


# ---------------------------------------------------------------------------
# the reduced replay and the checkpoints
# ---------------------------------------------------------------------------

def test_reduced_replay_matches_jax(tmp_path):
    """``cloth_automated_strain`` recorded for 40 frames by the JAX driver,
    its bases as the JAX e2e test builds them (POD + row DEIM, a position
    POD of the trajectory), then replayed fully reduced in both packages
    from the same files (the port on kernel 1's plain version, one
    ``run_steps(record=True)`` call; the JAX solver as its e2e test runs
    it): the trajectories within 1e-8 of the extent."""
    from animsnapbases_tpu.bases.position_reduction import (
        position_basis_from_trajectory,
        save_position_basis,
    )
    from reduction_helpers import pod_deim_basis

    params, args = small_args(tmp_path, jax=True,
                              vert_bending_constraint=False)
    fom = jax_scen.build_scenario("cloth_automated_strain", args,
                                  record_fom_info=True, params=params)
    fom.run(max_frames=40)
    basis_dir = str(tmp_path / "bases")
    for g in ("tris_strain", "edge_spring"):
        data = np.load(os.path.join(fom.record_path, g + "_p.npz"))
        frames = np.stack([data[str(i)] for i in sorted(map(int,
                                                            data.files))])
        os.makedirs(os.path.join(basis_dir, g))
        np.savez(os.path.join(basis_dir, g, "basis.npz"),
                 **pod_deim_basis(frames, fom.model.groups[g].p, 20))
    pos_path = str(tmp_path / "pos_basis.npz")
    save_position_basis(pos_path, position_basis_from_trajectory(
        np.array(fom.trajectory), 20))

    out = {}
    for jax in (True, False):
        params2, args2 = small_args(tmp_path / "replay", jax=jax,
                                    vert_bending_constraint=False)
        args2.solver = "animSnapBasesSolver"
        args2.constraint_projection_basis_type = "deim_pod_vectorized"
        args2.tri_strain_reduced = args2.edge_spring_reduced = True
        args2.tri_strain_num_components = 12
        args2.edge_spring_num_components = 12
        args2.deim_oversample = 1.4
        args2.geom_interpolation_basis_dir = basis_dir
        args2.geom_interpolation_basis_file = "basis.npz"
        args2.position_reduced = True
        args2.position_num_components = 20
        args2.position_basis_file = pos_path
        if jax:
            d = jax_scen.build_scenario("cloth_automated_strain", args2,
                                        params=params2)
        else:
            d = scen.build_scenario("cloth_automated_strain", args2,
                                    params=params2, device="cpu")
        d.run(max_frames=40)
        out[jax] = np.array(d.trajectory)
    assert out[True].shape == out[False].shape == (40, 36, 3)
    extent = float(np.abs(out[True]).max())
    per_frame = np.abs(out[True] - out[False]).max(axis=(1, 2)) / extent
    # the cloth reaches the floor at frame 34 or 35 (no vertex lower than
    # the floor's clamp before): from then on the floor clamp of each
    # step branches on the two packages' ~1e-12 rounding differences and
    # amplifies them (ROADMAP Queue C)
    landed = int(np.nonzero(out[True][:, :, 1].min(axis=1) < 1e-3)[0][0])
    assert 30 <= landed < 40
    assert per_frame[:landed].max() <= EXTENT_TOL
    assert per_frame.max() <= CONTACT_TOL


def test_jax_checkpoint_loads_and_continues_equal(tmp_path):
    """A checkpoint written by the JAX package loads into the port, which
    then steps as the JAX solver does from it; the port writes the same
    keys."""
    from animsnapbases_tpu.sim.checkpoint import save_sim_state as jax_save
    from animsnapbases_tpu_torch.sim.checkpoint import (
        load_sim_state,
        save_sim_state,
    )

    jd, pd = both(tmp_path, "cloth_automated_bend_spring_strain", 22,
                  record=False, positions=False)
    path = str(tmp_path / "state.npz")
    jax_save(path, jd.solver)
    load_sim_state(path, pd.solver)
    assert pd.solver.frame == 22 and not pd.solver.ready()
    np.testing.assert_array_equal(pd.model.positions, jd.model.positions)
    np.testing.assert_array_equal(pd.model.fixed_flags, jd.model.fixed_flags)
    for d in (jd, pd):
        d.run(max_frames=30)
    A, P = np.array(jd.trajectory[22:]), np.array(pd.trajectory[22:])
    assert len(A) == len(P) == 8
    assert float(np.abs(A - P).max()) <= EXTENT_TOL * float(np.abs(A).max())
    mine = str(tmp_path / "port.npz")
    save_sim_state(mine, pd.solver)
    assert sorted(np.load(mine).files) == sorted(np.load(path).files)
