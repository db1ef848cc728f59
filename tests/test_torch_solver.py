"""The full-order recorder of the PyTorch port (``ops/svd3.py``,
``ops/segment.py``, ``ops/cg.py``, ``sim/projections.py``,
``sim/solver.py``) against the JAX package, float64 on the CPU, on the
same seeded inputs.

Scenes: a 10x10 cloth (tilted out of its plane, its left side pinned,
tris_strain and edge_spring at wi = 1e4) and the tet bar at
``bar_model(4, 3, 3)`` (left end pinned, tets_strain, tets_deformation_
gradient, edge_spring and verts_bending on its surface), both lifted above
the floor, under gravity with damping 0.01.

Tolerances: the small decompositions, each projection and S^T p to 1e-12
(measured: at most 4.2e-14 on the singular values, 1.8e-15 elsewhere);
the trajectories and p-snapshots of ``Solver`` on each tier after 24
frames to 1e-10 of the scene's extent (measured: at most 8.1e-14 on the
trajectories and 4.0e-13 on the p-snapshots).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animsnapbases_tpu.config.sim_config import default_sim_args
from animsnapbases_tpu.geometry.procedural import bar_model as jax_bar
from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.ops import svd3 as jsvd
from animsnapbases_tpu.sim import projections as jproj
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.solver import Solver as JaxSolver
from animsnapbases_tpu_torch.geometry.procedural import bar_model, cloth_model
from animsnapbases_tpu_torch.ops import cg, segment, svd3
from animsnapbases_tpu_torch.sim import projections
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.solver import (
    Solver,
    device_group_data,
    make_local_stage,
)

TOL = 1e-12
TRAJ_TOL = 1e-10
FRAMES = 24


def cloth(cls, cloth_fn):
    V, F = cloth_fn(10, 10)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    m = cls(V, F, masses=np.full(len(V), 10.0), floor_collision=True,
            init_height_shift=0.3)
    m.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    m.add_edge_spring_constraint(wi=1e4)
    m.compute_cloth_corner_indices()
    m.fix_surface_side_vertices("left")
    return m


def bar(cls, bar_fn):
    V, T, F, _ = bar_fn(4, 3, 3)
    m = cls(V, F, elements=T, masses=np.full(len(V), 1.0),
            floor_collision=True, init_height_shift=0.2)
    m.add_tet_constrain_strain(0.9, 1.1, wi=1e4)
    m.add_tet_constrain_deformation_gradient(wi=1e3)
    m.add_edge_spring_constraint(wi=1e3)
    m.add_vertex_bending_constraint(wi=1e2)
    m.fix_side_vertices(side="left")
    return m


SCENES = {"cloth": (cloth, jax_cloth, cloth_model),
          "bar": (bar, jax_bar, bar_model)}


def models(scene):
    build, jfn, tfn = SCENES[scene]
    return build(JaxModel, jfn), build(DeformableModel, tfn)


def args(**kw):
    a = default_sim_args()
    a.dt = 0.016
    a.damping = 0.01
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def gravity(model):
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0
    return f


def deformed(model, seed=0):
    """The model's positions moved at random by ~0.05 (a state with every
    projection off its rest)."""
    rng = np.random.default_rng(seed)
    return model.positions + 0.05 * rng.normal(size=model.positions.shape)


# ---------------------------------------------------------------------------
# small decompositions
# ---------------------------------------------------------------------------

def _matrices(n, seed=0):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(200, n, n))
    F[0] = np.eye(n)                  # repeated singular values
    F[1] = 0.0                        # all zero
    F[2, :, 1] = F[2, :, 0]           # rank deficient
    F[3] = np.diag(np.arange(1.0, n + 1.0))
    return F


DECOMPOSITIONS = {
    "svd2x2": (2, jsvd.svd2x2, svd3.svd2x2),
    "svd3x3": (3, jsvd.svd3x3, svd3.svd3x3),
    "polar_rotation3x3": (3, jsvd.polar_rotation3x3, svd3.polar_rotation3x3),
    "jacobi_eigh2": (2, lambda S: jsvd.jacobi_eigh2(S + S.T),
                     lambda S: svd3.jacobi_eigh2(S + S.transpose(-1, -2))),
    "jacobi_eigh3": (3, lambda S: jsvd.jacobi_eigh3(S + S.T),
                     lambda S: svd3.jacobi_eigh3(S + S.transpose(-1, -2))),
}


@pytest.mark.parametrize("name", sorted(DECOMPOSITIONS))
def test_decompositions_match_jax(name):
    n, jfn, tfn = DECOMPOSITIONS[name]
    F = _matrices(n)
    want = jax.vmap(jfn)(jnp.asarray(F))
    got = tfn(torch.as_tensor(F))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL * 100)


@pytest.mark.parametrize("d", [2, 3])
def test_top_mode_rows_matches_jax(d):
    X = np.random.default_rng(d).normal(size=(40, d, 30))
    s_j, w_j = jax.vmap(jsvd.top_mode_rows)(jnp.asarray(X))
    s_t, w_t = svd3.top_mode_rows(torch.as_tensor(X))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=TOL * 100,
                               rtol=0)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=TOL * 100,
                               rtol=0)


# ---------------------------------------------------------------------------
# projections and S^T p
# ---------------------------------------------------------------------------

KINDS = [("cloth", "tris_strain"), ("cloth", "edge_spring"),
         ("bar", "tets_strain"), ("bar", "tets_deformation_gradient"),
         ("bar", "edge_spring"), ("bar", "verts_bending")]


@pytest.mark.parametrize("scene,kind", KINDS)
def test_projection_and_group_rhs_match_jax(scene, kind):
    jm, tm = models(scene)
    q = deformed(tm)
    g = tm.groups[kind]
    jdata = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                 and v.dtype != object else v)
             for k, v in jm.groups[kind].data.items()}
    p_j = np.asarray(jproj.PROJECTION_KERNELS[kind](jnp.asarray(q), jdata))
    p_t = projections.PROJECTION_KERNELS[kind](
        torch.as_tensor(q), device_group_data(g, torch.device("cpu"),
                                              torch.float64))
    scale = max(np.abs(p_j).max(), 1.0)
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0, atol=TOL * scale)
    b_j = np.asarray(jproj.group_rhs(jnp.asarray(g.st_rows),
                                     jnp.asarray(g.st_cols),
                                     jnp.asarray(g.st_vals),
                                     jnp.asarray(p_j), tm.n_verts))
    b_t = projections.group_rhs(g.st_rows, g.st_cols, g.st_vals,
                                torch.as_tensor(p_j), tm.n_verts)
    np.testing.assert_allclose(b_t.numpy(), b_j, rtol=0,
                               atol=TOL * np.abs(b_j).max())


def test_positional_projection_and_local_stage():
    """The positional group projects to its targets; the local stage sums
    every group's S^T p, as the JAX local stage does."""
    from animsnapbases_tpu.sim.solver import make_local_stage as jax_local

    jm, tm = models("cloth")
    for m in (jm, tm):
        m.add_positional_constraint(99, wi=1e4)
    q = deformed(tm, seed=3)
    targets = tm.positional_targets(0) + 0.1
    b_j, p_j = jax_local(jm)(jnp.asarray(q), jnp.asarray(targets))
    b_t, p_t = make_local_stage(tm, "cpu")(torch.as_tensor(q),
                                           torch.as_tensor(targets))
    assert sorted(p_t) == sorted(p_j)
    np.testing.assert_array_equal(p_t["positional"].numpy(), targets)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=0,
                               atol=TOL * np.abs(np.asarray(b_j)).max())


def test_row_sum_is_the_sorted_coo_sum():
    """``coo_matvec_cols`` sums each row's entries in their COO order, with
    duplicates and empty rows: the product of the dense matrix, and the
    same bits on every call."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 30, size=200)
    rows[:5] = 29
    cols = rng.integers(0, 40, size=200)
    vals = rng.normal(size=200)
    X = torch.as_tensor(rng.normal(size=(40, 3)))
    A = np.zeros((31, 40))
    np.add.at(A, (rows, cols), vals)
    Y = segment.coo_matvec_cols(rows, cols, vals, X, 31)
    np.testing.assert_allclose(Y.numpy(), A @ X.numpy(), rtol=0, atol=1e-13)
    assert torch.equal(Y, segment.coo_matvec_cols(rows, cols, vals, X, 31))
    assert not Y[30].any()


def test_pcg_matches_jax():
    from animsnapbases_tpu.ops import cg as jcg

    rng = np.random.default_rng(2)
    n = 50
    B = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.1)
    A = B @ B.T + np.diag(rng.random(n) * 10 + 1.0)
    r_, c_ = np.nonzero(A)
    cols, vals = cg.build_ell(r_, c_, A[r_, c_], n)
    jcols, jvals = jcg.build_ell(r_, c_, A[r_, c_], n)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    rhs = rng.normal(size=(n, 3))
    dinv = 1.0 / np.diag(A)
    x_j, it_j = jcg.pcg_solve(
        lambda x: jcg.ell_matvec(jnp.asarray(cols), jnp.asarray(vals), x),
        jnp.asarray(dinv), jnp.asarray(rhs), tol=1e-12, max_iters=400)
    ct, vt = torch.as_tensor(cols.astype(np.int64)), torch.as_tensor(vals)
    x_t, it_t = cg.pcg_solve(lambda x: cg.ell_matvec(ct, vt, x),
                             torch.as_tensor(dinv), torch.as_tensor(rhs),
                             tol=1e-12, max_iters=400)
    assert it_t == int(it_j)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(A @ x_t.numpy(), rhs, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["host", "dense", "cg"])
@pytest.mark.parametrize("scene", ["cloth", "bar"])
def test_solver_matches_jax(tmp_path, scene, tier):
    """24 frames under gravity, recorded, on one tier in both packages: the
    trajectories and every frame's p-snapshots to 1e-10 of the scene's
    extent, the same .npz files with the same keys."""
    jm, tm = models(scene)
    iters = 10 if scene == "cloth" else 5
    solvers = []
    for cls, m, kw in ((JaxSolver, jm, {}), (Solver, tm, {"device": "cpu"})):
        s = cls(tier, **kw)
        s.set_model(m)
        s.prepare(args(max_p_snapshots_num=FRAMES - 1))
        path = str(tmp_path / cls.__module__.split(".")[0])
        s.store_assembly_matrices(path)
        s.set_record_path(path)
        s.set_store_p(True)
        solvers.append(s)
    f = gravity(tm)
    t_j = solvers[0].run_steps(f, FRAMES, iters, record=True)
    t_t = solvers[1].run_steps(f, FRAMES, iters, record=True)
    extent = np.abs(t_j).max()
    assert t_t.shape == t_j.shape == (FRAMES, tm.n_verts, 3)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=TRAJ_TOL * extent)
    np.testing.assert_allclose(tm.velocities, jm.velocities, rtol=0,
                               atol=TRAJ_TOL * extent / 0.016)
    assert solvers[1].frame == solvers[0].frame == FRAMES
    jdir, tdir = (str(tmp_path / n) for n in ("animsnapbases_tpu",
                                              "animsnapbases_tpu_torch"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(tm.groups):
        a = np.load(os.path.join(jdir, name + "_p.npz"))
        b = np.load(os.path.join(tdir, name + "_p.npz"))
        assert b.files == a.files == [str(i) for i in range(FRAMES)]
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=0,
                                       atol=TRAJ_TOL * extent
                                       * max(1.0, np.abs(a[k]).max()))
    st_j = np.load(os.path.join(jdir, "assembly_ST.npz"), allow_pickle=True)
    st_t = np.load(os.path.join(tdir, "assembly_ST.npz"), allow_pickle=True)
    assert sorted(st_t.files) == sorted(st_j.files)
    for k in st_j.files:
        assert (st_t[k].item() != st_j[k].item()).nnz == 0
    if scene == "bar":
        np.testing.assert_array_equal(
            np.load(os.path.join(tdir, "verts_bending_constrained_indices"
                                       ".npz"))["indices"],
            np.load(os.path.join(jdir, "verts_bending_constrained_indices"
                                       ".npz"))["indices"])


def test_step_loop_equals_run_steps_on_device_tiers():
    """On a device tier ``step()`` and ``run_steps`` do the same arithmetic
    in two loops: the same trajectory within rounding."""
    _, a = models("cloth")
    _, b = models("cloth")
    solvers = []
    for m in (a, b):
        s = Solver("dense", device="cpu")
        s.set_model(m)
        s.prepare(args())
        solvers.append(s)
    f = gravity(a)
    for _ in range(6):
        solvers[0].step(f, 10)
    solvers[1].run_steps(f, 6, 10)
    np.testing.assert_allclose(a.positions, b.positions, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.positions_corrections,
                               b.positions_corrections, rtol=0, atol=1e-12)


def test_host_tier_splits_its_seconds():
    _, m = models("cloth")
    s = Solver("host", device="cpu")
    s.set_model(m)
    s.prepare(args())
    s.run_steps(gravity(m), 2, 3)
    assert set(s.seconds) == {"local", "transfer", "solve"}
    assert all(v > 0 for v in s.seconds.values())


def test_auto_tier_and_refusals():
    _, m = models("cloth")
    s = Solver(device="cpu")
    s.set_model(m)
    s.prepare(args())
    assert s._mode == "dense"                 # 3N = 300 <= DENSE_LIMIT
    s.DENSE_LIMIT = 10
    s.prepare(args())
    assert s._mode == "cg"
    s.enable_self_collision = "device"          # served: the device pass
    s.step(gravity(m))
    assert s._collide is not None and np.isfinite(m.positions).all()
    s.set_model(m)
    assert s._collide is None                   # keyed on the faces
    with pytest.raises(ValueError, match="global_solve"):
        bad = Solver("lu", device="cpu")
        bad.set_model(m)
        bad.prepare(args())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Solver()
