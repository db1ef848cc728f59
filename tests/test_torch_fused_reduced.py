"""Kernel 1 of the PyTorch port (``animsnapbases_tpu_torch.ops.fused_reduced``)
against the JAX package's ``build_fused_reduced_iterations`` in interpret
mode, float64 on the CPU, on operands carried across by
``convert.operands_from_numpy``; and the port's own packing against the
JAX package's.

Also home of the small scene both packages build for the port's tests.
"""

import os

import numpy as np
import pytest
import torch

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.utils.synthetic import (
    synthetic_reduced_solver as jax_synthetic,
)
from animsnapbases_tpu_torch.convert import operands_from_numpy
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.ops.fused_reduced import (
    fused_reduced_iterations,
    pack_edge_spring,
    pack_tris_strain,
    prepare_fused_operands,
)
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

DAMPING = 0.07


def small_model(cls, cloth=cloth_model, rows=10, cols=10):
    """A tilted 10x10 cloth whose bottom row starts on the floor (so the
    y-row clamp fires), left column pinned, tris_strain + edge_spring at
    wi = 1e4.  ``cls`` is either package's DeformableModel."""
    V, F = cloth(rows, cols)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    model = cls(V, F, masses=np.full(len(V), 10.0), floor_collision=True,
                init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    for vi in np.where(model.positions[:, 0] < 0.5)[0]:
        model.fix(vi)
    return model


def free_position_basis(model, r, path, seed=1):
    """Random per-dim orthonormal position basis, zero at pinned vertices
    (as a recorded POD basis is), so that the reduced solve does real
    work; written in the product schema."""
    rng = np.random.default_rng(seed)
    comps = np.empty((r, model.n_verts, 3))
    for d in range(3):
        X = rng.normal(size=(model.n_verts, r))
        X[model.fixed_flags] = 0.0
        Q, _ = np.linalg.qr(X)
        comps[:, :, d] = Q.T
    np.savez(path, components=comps)
    return str(path)


def gravity(model):
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0
    return f


def jax_solver(tmp_path, pallas_mode, free_basis=True, K=6, r=8):
    """The JAX package's synthetic fully-reduced solver on the small
    scene (its bases: utils/synthetic.py, optionally with the free
    position basis)."""
    model = small_model(JaxModel, jax_cloth)
    extra = {"damping": DAMPING}
    if free_basis:
        extra["position_basis_file"] = free_position_basis(
            model, r, tmp_path / "free_basis.npz")
    return jax_synthetic(model, K=K, r=r, pallas_mode=pallas_mode,
                         extra_args=extra), model


def port_solver(args):
    model = small_model(DeformableModel)
    solver = AnimSnapBasesSolver(args, device="cpu")
    solver.set_model(model)
    solver.prepare(args)
    return solver, model


def _loop_inputs(s_jax, model, seed=0):
    """snT_sel (3, n_sel) and rb_const (3, r) of a realistic step: the
    selected vertices of the predictor (perturbed from a seed) and
    -U^T A_c sn."""
    rng = np.random.default_rng(seed)
    st = s_jax._resident_state
    perm, n_sel = st["perm"], st["n_sel"]
    sn = model.positions + 0.02 * rng.normal(size=model.positions.shape)
    sn[:, 1] = np.maximum(sn[:, 1], model.floor_height)
    rb_const = -np.einsum("drn,nd->dr", s_jax._ut_ac_np, sn)
    return np.ascontiguousarray(sn[perm[:n_sel]].T), rb_const


@pytest.mark.parametrize("num_iterations", [1, 6])
def test_plain_matches_jax_interpret(tmp_path, num_iterations):
    """Port's plain kernel 1 == ``build_fused_reduced_iterations
    (interpret=True)``, float64, same operands (convert.operands_from_numpy).
    Measured max |du| 1.8e-15 (1 iteration) and 8.9e-16 (6) with max |u|
    1.0 and 1.6."""
    from animsnapbases_tpu.ops.pallas_reduced import (
        build_fused_reduced_iterations,
        prepare_fused_operands as jax_prepare,
    )

    s_jax, model = jax_solver(tmp_path, "interpret")
    packed, U_selT, inv3, _, _ = s_jax._fused_pack
    run = build_fused_reduced_iterations(packed, U_selT, inv3,
                                         interpret=True)
    fo, _ = operands_from_numpy(jax_prepare(packed, U_selT, inv3), "cpu",
                                torch.float64)
    snT_sel, rb_const = _loop_inputs(s_jax, model)
    u_jax = np.asarray(run(snT_sel, rb_const, num_iterations))
    u = fused_reduced_iterations(fo, torch.from_numpy(snT_sel),
                                 torch.from_numpy(rb_const), num_iterations)
    assert np.abs(u_jax).max() > 1e-2       # the solve does real work
    np.testing.assert_allclose(u.numpy(), u_jax, rtol=0, atol=1e-10)


def test_port_packing_reproduces_jax(tmp_path):
    """The port's pack_* + prepare_fused_operands on the port's own prepare
    reproduce the JAX package's arrays: gather and rhs matrices exactly,
    the float64 products to 1e-12."""
    from animsnapbases_tpu.ops.pallas_reduced import (
        prepare_fused_operands as jax_prepare,
    )

    s_jax, _ = jax_solver(tmp_path, "interpret")
    ops_jax = jax_prepare(*s_jax._fused_pack[:3])
    s_port, _ = port_solver(s_jax.args)
    union, remapped = s_port._remapped_subsets()
    ident = np.arange(len(union))
    packed = []
    for name, rg in s_port._reduced_groups.items():
        if name == "tris_strain":
            packed.append(pack_tris_strain(remapped[name], ident, rg.W,
                                           rg.row_select, np.float64))
        else:
            packed.append(pack_edge_spring(remapped[name], ident, rg.W,
                                           np.float64))
    U_selT = np.ascontiguousarray(s_port.U[union].transpose(2, 1, 0))
    ops = prepare_fused_operands(packed, U_selT, s_port._inv_np)
    np.testing.assert_array_equal(ops["G_allT"], ops_jax["G_allT"])
    np.testing.assert_array_equal(ops["WT_all"], ops_jax["WT_all"])
    assert ops["layout"] == ops_jax["layout"]
    assert ops["gather_slices"] == ops_jax["gather_slices"]
    for a, b in zip(ops["flat_arrays"], ops_jax["flat_arrays"]):
        np.testing.assert_array_equal(a, b)
    for key in ("C_allT", "inv3"):
        np.testing.assert_allclose(ops[key], ops_jax[key], rtol=1e-12,
                                   atol=1e-12 * np.abs(ops_jax[key]).max())


def test_element_table_matches_layout(tmp_path):
    """The element table the kernel reads (kinds, Vall columns, rest data)
    is the JAX layout re-indexed: every column of G_allT is one gather row
    (one sparse entry of weight 1 at its argmax), and each element's slots
    point at its group's gather slices."""
    from animsnapbases_tpu.ops.pallas_reduced import (
        prepare_fused_operands as jax_prepare,
    )

    s_jax, _ = jax_solver(tmp_path, "interpret")
    ops = jax_prepare(*s_jax._fused_pack[:3])
    fo, _ = operands_from_numpy(ops, "cpu", torch.float64)
    G = ops["G_allT"]
    np.testing.assert_array_equal(np.diff(fo.gptr.numpy()), 1)
    np.testing.assert_array_equal(fo.gcol.numpy(), G.argmax(axis=0))
    np.testing.assert_array_equal(fo.gw.numpy(), 1.0)
    col = 0
    for (kind, _, smin, smax, _, _), slices in zip(ops["layout"],
                                                   ops["gather_slices"]):
        m = slices[0][1]
        assert (fo.elem_kind[col:col + m] == (0 if kind == "tris_strain"
                                              else 1)).all()
        for s, (start, _) in enumerate(slices):
            np.testing.assert_array_equal(fo.elem_g[s, col:col + m].numpy(),
                                          start + np.arange(m))
        if kind == "tris_strain":
            assert (fo.elem_f[11, col:col + m] == smin).all()
            assert (fo.elem_f[12, col:col + m] == smax).all()
        col += m
    assert col == fo.m_total


def test_wrapper_rejects_unported_layouts(tmp_path):
    """A group kind without an emitter, and a layout whose columns do not
    cover WT_all (a row-form group declared block form, which would take
    twice its columns), raise instead of running.  (Every kind of the JAX
    package in both forms, and non-one-hot gathers, are ported:
    tests/test_torch_emitters.py.)"""
    from animsnapbases_tpu.ops.pallas_reduced import (
        prepare_fused_operands as jax_prepare,
    )

    s_jax, _ = jax_solver(tmp_path, "interpret")
    ops = dict(jax_prepare(*s_jax._fused_pack[:3]))
    layout = list(ops["layout"])
    kind, cnt, smin, smax, pflips, _ = layout[0]
    ops["layout"] = [("tris_bending", cnt, smin, smax, pflips, False)
                     ] + layout[1:]
    with pytest.raises(NotImplementedError):
        operands_from_numpy(ops, "cpu", torch.float64)
    ops = dict(jax_prepare(*s_jax._fused_pack[:3]))
    ops["layout"] = [(kind, cnt, smin, smax, pflips, True)] + layout[1:]
    with pytest.raises(ValueError):
        operands_from_numpy(ops, "cpu", torch.float64)


def test_synthetic_bases_are_the_jax_bases(tmp_path):
    """The port's utils/synthetic.py writes the same .npz bases as the JAX
    package's (same seed, same draws, same schema)."""
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    s_jax, _ = jax_solver(tmp_path, "off", free_basis=False)
    s_port = synthetic_reduced_solver(small_model(DeformableModel), K=6, r=8,
                                      device="cpu",
                                      work_dir=str(tmp_path / "port"))
    for name in ("tris_strain", "edge_spring"):
        a = np.load(os.path.join(s_jax.args.geom_interpolation_basis_dir,
                                 name, "basis.npz"))
        b = np.load(os.path.join(s_port.args.geom_interpolation_basis_dir,
                                 name, "basis.npz"))
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(
        np.load(s_jax.args.position_basis_file)["components"],
        np.load(s_port.args.position_basis_file)["components"])
