"""The tet, bending and block-form projections of the PyTorch port
(``animsnapbases_tpu_torch.ops.fused_reduced``: ``pack_tets``,
``pack_verts_bending``, block-form ``pack_tris_strain``, the element
table, the sparse gather columns and the plain emitters) against the JAX
package, float64 on the CPU, on the same seeded inputs.

Scenes: the reference's tet bar at ``bar_model(4, 3, 3)`` (bending on its
surface triangles, curved at the bar's edges and corners: on a flat rest
cloth every bending row projects to 0, which would hold nothing) and a
10x10 cloth.  The bases are the port's ``utils/synthetic.py`` draws, read
by both packages, with a position basis zero at the pinned vertices (so
that the reduced solve does real work), oversampled 1.5x (square DEIM on
tets is chaotic at these settings, as ``tests/test_pallas_all_groups.py``
notes).

Tolerances: the plain loop against ``build_fused_reduced_iterations
(interpret=True)`` and the solver's steps against the JAX solver's to
1e-12 (measured: the loop at most 3.1e-16 on the tet and bending cases,
7.7e-15 on block-form tris, whose 2x2 clamp takes the non-cancelling half
angle (ROADMAP Queue C); P after 3 steps at most 1.0e-13, V 5.6e-13 at a
1e-9 tolerance); the packed arrays exactly, the float64 products to 1e-12
of their scale; the one-hot sparse gather bit for bit.
"""

import copy
import os

import numpy as np
import pytest
import torch

from animsnapbases_tpu.geometry.procedural import bar_model as jax_bar
from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu_torch.convert import operands_from_numpy
from animsnapbases_tpu_torch.geometry.procedural import bar_model, cloth_model
from animsnapbases_tpu_torch.ops.fused_reduced import (
    KIND_CODES,
    fused_reduced_iterations,
    gather_vc,
    pack_edge_spring,
    pack_tets,
    pack_tris_strain,
    pack_verts_bending,
    prepare_fused_operands,
)
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.utils.synthetic import synthetic_reduced_solver
from test_torch_fused_reduced import (
    _loop_inputs,
    free_position_basis,
    gravity,
)

TOL = 1e-12
OVERSAMPLE = 1.5


def bar(cls, bar_fn, kinds):
    """The 4x3x3 tet bar lifted 1 unit, its left end pinned, with the
    groups of ``kinds``."""
    V, T, F, _ = bar_fn(4, 3, 3)
    model = cls(V, F, elements=T, masses=np.full(len(V), 10.0),
                floor_collision=True, init_height_shift=1.0)
    for kind in kinds:
        if kind == "tets_strain":
            model.add_tet_constrain_strain(0.95, 1.05, wi=1e5)
        elif kind == "tets_deformation_gradient":
            model.add_tet_constrain_deformation_gradient(wi=1e5)
        else:
            model.add_vertex_bending_constraint(wi=50.0)
    model.fix_side_vertices(side="left", threshold=0.5, axis=0)
    return model


def cloth(cls, cloth_fn, kinds):
    """A 10x10 cloth, curved (z = 0.2 sin x), lifted 3 units, its left
    surface side pinned."""
    V, F = cloth_fn(10, 10)
    V = V.copy()
    V[:, 2] += 0.2 * np.sin(V[:, 0])
    model = cls(V, F, masses=np.full(len(V), 10.0), floor_collision=True,
                init_height_shift=3.0)
    for kind in kinds:
        if kind == "tris_strain":
            model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
        elif kind == "edge_spring":
            model.add_edge_spring_constraint(wi=1e4)
        else:
            model.add_vertex_bending_constraint(wi=50.0)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


SCENES = {"bar": (bar, bar_model, jax_bar), "cloth": (cloth, cloth_model,
                                                      jax_cloth)}
# (scene, group kinds, block form) of each case
CASES = {
    "tets_strain": ("bar", ("tets_strain",), False),
    "tets_strain_block": ("bar", ("tets_strain",), True),
    "tets_deformation_gradient": ("bar", ("tets_deformation_gradient",),
                                  False),
    "tets_deformation_gradient_block": (
        "bar", ("tets_deformation_gradient",), True),
    "verts_bending": ("bar", ("verts_bending",), False),
    "bar_all": ("bar", ("tets_strain", "tets_deformation_gradient",
                        "verts_bending"), False),
    "bar_all_block": ("bar", ("tets_strain", "tets_deformation_gradient",
                              "verts_bending"), True),
    "cloth_bending": ("cloth", ("verts_bending", "tris_strain",
                                "edge_spring"), False),
    "tris_strain_block": ("cloth", ("tris_strain",), True),
    "cloth_block": ("cloth", ("verts_bending", "tris_strain", "edge_spring"),
                    True),
}


def solvers(tmp_path, case, pallas_mode="interpret", K=6, r=8):
    """(port solver, port model, JAX solver, JAX model) of ``case`` on the
    same bases (the port's synthetic draws)."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    scene, kinds, block = CASES[case]
    build, port_fn, jax_fn = SCENES[scene]
    model = build(DeformableModel, port_fn, kinds)
    pos = free_position_basis(model, r, tmp_path / "free_basis.npz")
    s = synthetic_reduced_solver(model, K=K, r=r, device="cpu",
                                 work_dir=str(tmp_path), block=block,
                                 oversample=OVERSAMPLE,
                                 extra_args={"damping": 0.07,
                                             "position_basis_file": pos})
    jmodel = build(JaxModel, jax_fn, kinds)
    sj = JaxSolver(copy.copy(s.args), pallas_mode=pallas_mode)
    sj.set_model(jmodel)
    sj.prepare(sj.args)
    return s, model, sj, jmodel


def _jax_ops(sj):
    from animsnapbases_tpu.ops.pallas_reduced import prepare_fused_operands

    return prepare_fused_operands(*sj._fused_pack[:3])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("num_iterations", [1, 6])
def test_plain_loop_matches_jax_interpret(tmp_path, case, num_iterations):
    """The port's plain kernel 1 on the JAX package's packed operands
    (``convert.operands_from_numpy``) == ``build_fused_reduced_iterations
    (interpret=True)``, float64, from the same snT_sel and rb_const."""
    from animsnapbases_tpu.ops.pallas_reduced import (
        build_fused_reduced_iterations,
    )

    _, _, sj, jmodel = solvers(tmp_path, case)
    run = build_fused_reduced_iterations(*sj._fused_pack[:3], interpret=True)
    fo, _ = operands_from_numpy(_jax_ops(sj), "cpu", torch.float64)
    snT_sel, rb_const = _loop_inputs(sj, jmodel)
    u_jax = np.asarray(run(snT_sel, rb_const, num_iterations))
    u = fused_reduced_iterations(fo, torch.from_numpy(snT_sel),
                                 torch.from_numpy(rb_const), num_iterations)
    assert np.abs(u_jax).max() > 1e-3            # the solve does real work
    np.testing.assert_allclose(u.numpy(), u_jax, rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_port_packing_reproduces_jax(tmp_path, case):
    """The port's packers and ``prepare_fused_operands`` on the port's own
    prepare reproduce the JAX package's arrays: gather and rhs matrices
    (block columns permuted by ``_block_major``), layout and rest data
    exactly, the float64 products to 1e-12 of their scale."""
    s, _, sj, _ = solvers(tmp_path, case)
    ops_jax = _jax_ops(sj)
    union, remapped = s._remapped_subsets()
    ident = np.arange(len(union))
    packed = []
    for name, rg in s._reduced_groups.items():
        sub = remapped[name]
        if name == "tris_strain":
            packed.append(pack_tris_strain(sub, ident, rg.W, rg.row_select,
                                           np.float64))
        elif name == "edge_spring":
            packed.append(pack_edge_spring(sub, ident, rg.W, np.float64))
        elif name == "verts_bending":
            packed.append(pack_verts_bending(sub, ident, rg.W, np.float64))
        else:
            packed.append(pack_tets(name, sub, ident, rg.W, rg.row_select,
                                    np.float64))
    U_selT = np.ascontiguousarray(s.U[union].transpose(2, 1, 0))
    ops = prepare_fused_operands(packed, U_selT, s._inv_np)
    np.testing.assert_array_equal(ops["G_allT"], ops_jax["G_allT"])
    np.testing.assert_array_equal(ops["WT_all"], ops_jax["WT_all"])
    assert ops["layout"] == ops_jax["layout"]
    assert ops["gather_slices"] == ops_jax["gather_slices"]
    for a, b in zip(ops["flat_arrays"], ops_jax["flat_arrays"]):
        np.testing.assert_array_equal(a, b)
    for key in ("C_allT", "UG_allT", "inv3"):
        np.testing.assert_allclose(ops[key], ops_jax[key], rtol=0,
                                   atol=TOL * np.abs(ops_jax[key]).max())


@pytest.mark.parametrize("case", ["tets_strain_block", "bar_all_block",
                                  "tris_strain_block", "cloth_block"])
def test_block_columns_follow_block_major(tmp_path, case):
    """Block form: table column j = k m + e of a group with p rows per
    element is row k of element e: its vertex slots are element e's, its
    fixed row is k's (tris ``row_is0`` 1 then 0; tets (r0, r1) = (1, 0),
    (0, 1), (0, 0)), and WT_all's column j is the element-major column
    e p + k of the group's W (``_block_major``)."""
    s, _, _, _ = solvers(tmp_path, case)
    fo = s._resident.fused
    wt_col = 0
    for name, c0, cols, _, _ in fo.segments:
        rg = s._reduced_groups[name]
        p = rg.p if rg.row_select is None else 1
        m = cols // p
        assert m == rg.num_selected and cols == m * p
        for k in range(p):
            blk = slice(c0 + k * m, c0 + (k + 1) * m)
            assert (fo.elem_kind[blk] == KIND_CODES[name]).all()
            np.testing.assert_array_equal(fo.elem_g[:, blk],
                                          fo.elem_g[:, c0:c0 + m])
            if name == "tris_strain" and p == 2:
                assert (fo.elem_f[10, blk] == (1.0 if k == 0 else 0.0)).all()
            if name.startswith("tets") and p == 3:
                r0, r1 = [(1, 0), (0, 1), (0, 0)][k]
                assert (fo.elem_f[9, blk] == r0).all()
                assert (fo.elem_f[10, blk] == r1).all()
            for e in range(m):
                np.testing.assert_array_equal(
                    fo.WT_all[:, c0 + k * m + e, :].numpy(),
                    rg.W[:, :, e * p + k])
        wt_col += cols
    assert wt_col == fo.m_total
    assert any(s._reduced_groups[n].row_select is None
               and s._reduced_groups[n].p > 1 for n, *_ in fo.segments)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_onehot_sparse_gather_is_the_index_gather(tmp_path, dtype):
    """One-hot columns (tris, springs, tets) have one entry of weight 1,
    and their sparse gather equals the index gather ``x[..., argmax]`` of
    the previous slices bit for bit, batched too; a bending column is the
    weighted star sum ``x G_allT`` (to 1e-14 of its scale in float64)."""
    s, _, sj, _ = solvers(tmp_path, "cloth_bending")
    G = _jax_ops(sj)["G_allT"]
    fo, _ = operands_from_numpy(_jax_ops(sj), "cpu", dtype)
    onehot = ((G == 0) | (G == 1)).all(0) & ((G == 1).sum(0) == 1)
    assert onehot.any() and not onehot.all()
    counts = np.diff(fo.gptr.numpy())
    assert (counts[onehot] == 1).all() and (fo.gw.numpy()[
        fo.gptr.numpy()[:-1][onehot]] == 1.0).all()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(20.0 + rng.normal(size=(2, 3, G.shape[0])),
                        dtype=dtype)
    got = gather_vc(fo, x)
    idx = torch.as_tensor(G.argmax(axis=0)[onehot])
    assert torch.equal(got[..., torch.as_tensor(onehot)], x[..., idx])
    star = (x.double() @ torch.as_tensor(G))[..., ~onehot]
    np.testing.assert_allclose(
        got[..., torch.as_tensor(~onehot)].double().numpy(), star.numpy(),
        rtol=0, atol=(1e-14 if dtype == torch.float64 else 1e-5)
        * float(x.abs().max()))


@pytest.mark.parametrize("case", list(CASES))
def test_solver_steps_match_jax(tmp_path, case):
    """``prepare -> step`` x 3 under gravity: the port's solver (kernel 1's
    plain version) against the JAX solver's ``pallas_mode="interpret"``
    steps, from the same bases, float64."""
    s, model, sj, jmodel = solvers(tmp_path, case)
    f = gravity(model)
    for _ in range(3):
        s.step(f, num_iterations=6)
        sj.step(f, num_iterations=6)
    assert np.abs(model.positions - model.init_positions).max() > 1e-3
    np.testing.assert_allclose(model.positions, jmodel.positions, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(model.velocities, jmodel.velocities, rtol=0,
                               atol=1e3 * TOL)


def test_host_model_layers_match_jax():
    """The host pieces this slice ports, against the JAX package's: the
    bar and its surface mesh (``bar_model``, ``bar_surface_mesh``,
    ``boundary_facets``), the tet and bending groups' rest data with the
    area masses, the side and corner fixers, and the JSON ``SimConfig`` on
    the reference's bar and bending-cloth demos; exactly (float64)."""
    from animsnapbases_tpu.config.sim_config import SimConfig as JaxConfig
    from animsnapbases_tpu.geometry.procedural import (
        bar_surface_mesh as jax_surface,
    )
    from animsnapbases_tpu_torch.config.sim_config import SimConfig
    from animsnapbases_tpu_torch.geometry.procedural import bar_surface_mesh

    for a, b in zip(bar_model(5, 3, 4), jax_bar(5, 3, 4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(bar_surface_mesh(5, 3, 4), jax_surface(5, 3, 4)):
        np.testing.assert_array_equal(a, b)
    kinds = ("tets_strain", "tets_deformation_gradient", "verts_bending")
    for build, port_fn, jax_fn in SCENES.values():
        m, mj = build(DeformableModel, port_fn, kinds), build(
            JaxModel, jax_fn, kinds)
        np.testing.assert_array_equal(m.fixed_flags, mj.fixed_flags)
        np.testing.assert_array_equal(m.mass, mj.mass)
        assert m.fixed_flags.any() and not m.fixed_flags.all()
        np.testing.assert_array_equal(
            m.vertex_masses(m.faces, m.positions),
            mj.vertex_masses(mj.faces, mj.positions))
        for name, g in m.groups.items():
            gj = mj.groups[name]
            assert sorted(g.data) == sorted(gj.data)
            for key, val in g.data.items():
                np.testing.assert_array_equal(np.asarray(val),
                                              np.asarray(gj.data[key]))
    for side in ("left", "right", "top", "bottom"):
        m = cloth(DeformableModel, cloth_model, ())
        mj = cloth(JaxModel, jax_cloth, ())
        m.fix_surface_side_vertices(side)
        mj.fix_surface_side_vertices(side)
        np.testing.assert_array_equal(m.fixed_flags, mj.fixed_flags)
    for demo, system in (
            ("configs/demos/bar_automated_deformationgradient.json", "Bar"),
            ("configs/demos/cloth_automated_bend_spring_strain.json",
             "Cloth")):
        demo = os.path.join(os.path.dirname(__file__), "..", demo)
        assert vars(SimConfig(demo).build_args(system)) == vars(
            JaxConfig(demo).build_args(system))
