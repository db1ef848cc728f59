"""The block forms of the bases in the PyTorch port
(``bases/constraints.py``: ``pod``, ``pca_blocks``, ``pca_blocks_with_St``,
``deim_blocksForm``, the geometric selection, ``geom_constructed``;
``ops/deim_scan.py`` ``deim_blocks``; ``geometry/mesh.py``'s incidence
queries) against the JAX package, float64 on the CPU, on the same seeded
inputs (``synthetic_p_tensor`` of ``tests/test_torch_bases.py``).

Tolerances.  The greedy deflations (``pca_blocks``, ``pca_blocks_with_St``)
take the same dominant mode of each row (the same Jacobi ``top_mode_rows``)
and deflate in the same order: their components are held at 1e-10 of the
largest, per mode and up to sign, with the same selected blocks (measured
~4e-14).  The per-slice ``pod`` is held per (p, d) slice and mode, up to
sign, within ``chip_smoke.pod_bounds`` of that slice's singular values.
The selections run the same float64 host arithmetic in both packages, and
are held equal on the same components; the device block-DEIM loops of the
two packages give equal picks on random bases.  ``geom_constructed`` and
its errors to 1e-10.
"""

import csv
import glob
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from animsnapbases_tpu.bases import constraints as jcons
from animsnapbases_tpu.geometry import mesh as jmesh
from animsnapbases_tpu.ops import deim_scan as jdeim
from animsnapbases_tpu.ops import podlinalg as jpod
from animsnapbases_tpu_torch.bases import constraints as tcons
from animsnapbases_tpu_torch.geometry import mesh
from animsnapbases_tpu_torch.geometry.procedural import bar_model, cloth_model
from animsnapbases_tpu_torch.ops import deim_scan
from animsnapbases_tpu_torch.sim.model import DeformableModel
from test_torch_bases import PACKAGES, make_cc, synthetic_p_tensor

@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread and one BLAS thread: these tensors and host
    solves are small, and threads spinning beside other test workers only
    slow the loops down."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


GROUP = {"tris": ("tris_strain", "_tris"), "edges": ("edge_spring", "_edges"),
         "tets": ("tets_deformation_gradient", "_tets"),
         "verts": ("verts_bending", "_verts")}


def scene(kind):
    """A small model with one group of ``kind`` -> (model, group)."""
    if kind == "tets":
        V, T, F, _ = bar_model(4, 3, 3)
        model = DeformableModel(V, F, elements=T,
                                masses=np.full(len(V), 1.0))
        model.add_tet_constrain_deformation_gradient(1.0)
    else:
        V, F = cloth_model(4, 4)
        V = V.copy()
        V[:, 2] = 0.3 * np.sin(V[:, 0]) * np.cos(V[:, 1])
        model = DeformableModel(V, F, masses=np.full(len(V), 1.0))
        if kind == "tris":
            model.add_tri_constrain_strain(0.95, 1.05, wi=1.0)
        elif kind == "edges":
            model.add_edge_spring_constraint(wi=1.0)
        else:
            model.add_vertex_bending_constraint(1.0)
    return model, model.groups[GROUP[kind][0]]


def components(pkg, tmp_path, kind, K=6, F=14, seed=0, **cp):
    """``pkg``'s ConstraintComponents on synthetic snapshots of the group
    of ``kind``: its St, its elements, and for bending the constrained-
    vertex file."""
    model, g = scene(kind)
    St = g.assembly_scipy(model.n_verts).tocsr()
    e = St.shape[1] // g.p
    X = synthetic_p_tensor(F=F, e=e, p=g.p, seed=seed)
    cc = make_cc(pkg, tmp_path / kind, X, p=g.p, K=K, **cp)
    cc.St = St
    snaps = cc.nonlinearSnapshots
    snaps.ele_type = GROUP[kind][1]
    snaps.tris = model.faces
    snaps.tets = model.elements if kind == "tets" else None
    snaps.edges = (jmesh.unique_edges(model.faces) if kind == "edges"
                   else None)
    cc.param.constProj_snapshots_type = GROUP[kind][0]
    if kind == "verts":
        path = str(tmp_path / "constrained.npz")
        np.savez(path, indices=np.asarray(g.data["indices"]))
        cc.param.constProj_input_snaps_constrained_elements = path
    return cc


def test_incidence_queries_match_jax():
    V, T, F, _ = bar_model(4, 3, 3)
    for elements in (T, F, mesh.unique_edges(F)):
        for v in (0, 7, len(V) - 1):
            assert (mesh.elements_per_vertex([v], elements)
                    == jmesh.elements_per_vertex([v], elements))
        assert (mesh.elements_per_vertex([1, 5], elements)
                == jmesh.elements_per_vertex([1, 5], elements))
    for v in range(len(V)):
        assert (mesh.vertex_star_vertices(v, F)
                == jmesh.vertex_star_vertices(v, F))


# ---------------------------------------------------------------------------
# the bases
# ---------------------------------------------------------------------------

def read_csv(cc):
    path, = glob.glob(os.path.join(cc.param.constProj_output_directory,
                                   "*.csv"))
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("btype", ["pca_blocks", "pca_blocks_with_St"])
def test_greedy_deflations_match_jax(tmp_path, btype):
    """Both greedy deflations on the cloth's tris (p = 2), with the
    singular-value CSV: the same blocks, components and weights within
    1e-10 up to sign, the same CSV rows; pca_blocks_with_St stops at its
    cap with the same warning."""
    out = {}
    for pkg in PACKAGES:
        cc = components(pkg, tmp_path / pkg, "tris", basis_type=btype,
                        store_sing_val=True)
        cc.storeSingVal = True
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cc.compute_components_store_singvalues()
        out[pkg] = (cc, [str(x.message) for x in w
                         if "pca_blocks" in str(x.message)])
    (a, wa), (b, wb) = out["jax"], out["torch"]
    assert wa == wb and (btype == "pca_blocks") == (not wb)
    assert b.comps.shape == a.comps.shape and b.numComp == a.numComp
    scale = np.abs(a.comps).max()
    assert cs.sign_aligned_diff(a.comps, b.comps).max() <= 1e-10 * scale
    sign = np.where((a.comps * b.comps).sum(axis=(1, 2)) < 0, -1.0, 1.0)
    np.testing.assert_allclose(b.weigs * sign, a.weigs, rtol=0,
                               atol=1e-10 * np.abs(a.weigs).max())
    np.testing.assert_array_equal(b.largeDeforPoints, a.largeDeforPoints)
    if btype == "pca_blocks":
        np.testing.assert_array_equal(b.largeDeforBlocks, a.largeDeforBlocks)
    rows_a, rows_b = read_csv(a), read_csv(b)
    assert rows_a[0] == rows_b[0] == ["component", "idx",
                                      "residual_matrix_norm", "singVal0",
                                      "singVal1"]
    assert len(rows_a) == len(rows_b) == a.numComp + 1
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        assert ra[:2] == rb[:2]
        np.testing.assert_allclose(np.array(rb[2:], float),
                                   np.array(ra[2:], float), rtol=1e-10,
                                   atol=1e-12 * scale)


def test_per_slice_pod_matches_jax(tmp_path):
    """``pod``: each (p, d) slice's modes within the Gram method's rounding
    of that slice (``chip_smoke.pod_bounds``), the leading ones at 1e-9,
    up to each slice's sign; the CSV header of the POD types."""
    out = {}
    for pkg in PACKAGES:
        cc = components(pkg, tmp_path / pkg, "tris", basis_type="pod",
                        store_sing_val=True)
        cc.storeSingVal = True
        cc.compute_components_store_singvalues()
        out[pkg] = cc
    a, b = out["jax"], out["torch"]
    assert read_csv(b) == read_csv(a) == [["component", "singVal"]]
    K, ep, d = a.comps.shape
    assert b.comps.shape == a.comps.shape
    X = a.nonlinearSnapshots.snapTensor
    F, p = X.shape[0], 2
    Xs = X.reshape(F, ep // p, p, d)
    ca, cb = (c.reshape(K, ep // p, p, d) for c in (a.comps, b.comps))
    for i in range(p):
        for l in range(d):
            S = np.asarray(jpod.snapshot_pod(jnp.asarray(Xs[:, :, i, l].T))[1])
            _, du = cs.pod_bounds(S, K)
            diff = cs.sign_aligned_diff(ca[:, :, i, l], cb[:, :, i, l])
            assert (diff <= du).all() and diff[0] <= 1e-9, (i, l)


# ---------------------------------------------------------------------------
# block DEIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,K", [(1, 30), (2, 40), (3, 24)])
def test_deim_blocks_scan_matches_jax(p, K):
    """The device loop on a random basis: the JAX scan's picks, and the
    reference's output convention."""
    bases = np.random.default_rng(K + p).normal(size=(90 * p, K * p, 3))
    want = np.asarray(jdeim.deim_blocks(jnp.asarray(bases), p))
    got = deim_scan.deim_blocks(bases, p, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    for g, w in zip(deim_scan.deim_blocks_host_result(bases, p, K - 3,
                                                      device="cpu"),
                    jdeim.deim_blocks_host_result(jnp.asarray(bases), p,
                                                  K - 3)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("K", [40, 64])
def test_deim_blocks_form_backends_match_jax(tmp_path, monkeypatch, K):
    """deim_blocksForm on both backends and the default (the host loop
    below 64 blocks, the device loop at and above): the JAX host loop's
    picks."""
    p = 2
    comps = np.random.default_rng(K + 2).normal(size=(K * p, 200, 3))
    ccs = {pkg: make_cc(pkg, tmp_path / pkg, synthetic_p_tensor(), K=K)
           for pkg in PACKAGES}
    for cc in ccs.values():
        cc.comps = comps.copy()
        cc.numComp = K
    ccs["jax"].deim_blocksForm(device=False)
    want = (ccs["jax"].geom_Pt, ccs["jax"].geom_alpha,
            ccs["jax"].geom_alpha_ranges)
    calls = []
    real = tcons.deim_blocks_host_result
    monkeypatch.setattr(tcons, "deim_blocks_host_result",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cc = ccs["torch"]
    for device in (False, True, None):
        calls.clear()
        cc.deim_blocksForm(device=device)
        for got, w in zip((cc.geom_Pt, cc.geom_alpha, cc.geom_alpha_ranges),
                          want):
            np.testing.assert_array_equal(got, w)
        assert bool(calls) == (device or (device is None and K >= 64))


@pytest.mark.parametrize("device", [False, True])
def test_deim_blocks_form_truncates_at_a_zero_residual(tmp_path, monkeypatch,
                                                       device):
    """A rank-deficient block basis (block 3 in the span of blocks 0-2):
    the host loop truncates at block 3 with a warning; duplicate device
    picks (forced) warn and re-run on the host.  As in the JAX package."""
    rng = np.random.default_rng(5)
    comps = rng.normal(size=(10, 60, 3))
    comps[6:8] = 0.5 * comps[0:2] - 2.0 * comps[4:6]
    dup = (np.arange(10), np.array([3, 7, 3, 1, 0]), np.arange(1, 6))
    monkeypatch.setattr(tcons, "deim_blocks_host_result", lambda *a, **k: dup)
    monkeypatch.setattr(jdeim, "deim_blocks_host_result", lambda *a, **k: dup)
    out = {}
    for pkg in PACKAGES:
        cc = make_cc(pkg, tmp_path / pkg, synthetic_p_tensor(), K=5)
        cc.comps = comps.copy()
        cc.numComp = 5
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cc.deim_blocksForm(device=device)
        out[pkg] = (cc.numComp, cc.geom_alpha.tolist(), len(cc.comps),
                    [str(x.message) for x in w])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 3 and out["torch"][2] == 6
    assert any("zero residual at mode 3" in m for m in out["torch"][3])
    assert device == any("duplicate selections" in m
                         for m in out["torch"][3])


# ---------------------------------------------------------------------------
# the geometric selection and the reconstruction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,pos_space", [
    ("tris", True), ("tris", False), ("edges", True), ("edges", False),
    ("tets", True), ("tets", False), ("verts", True)])
def test_geom_selection_matches_jax(tmp_path, kind, pos_space):
    """The geometric selection on pod_vectorized components of each
    element kind, in both error modes (the bending stars through the
    constrained-vertex map, which only the position-space mode reads), at
    two caps of new elements a vertex: on the same components both packages
    select the same elements, rows, vertices and ranges, with the same
    warnings; on each package's own POD they select the same elements
    too."""
    for cap in (100, 2):
        out = {}
        for pkg in PACKAGES:
            cc = components(pkg, tmp_path / pkg / str(cap), kind,
                            max_element_per_geom_vert=cap)
            cc.compute_components_store_singvalues()
            out[pkg] = cc
        own = {}
        for pkg, cc in out.items():
            mine = cc.comps.copy()
            for comps in (out["jax"].comps.copy(), mine):
                cc.comps = comps.copy()
                cc.numComp = 6
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    cc.geom_block_form_utilizing_differential_operator(
                        error_in_pos_space=pos_space)
                own.setdefault(pkg, []).append((
                    cc.numComp, cc.geom_alpha.tolist(), cc.geom_Pt.tolist(),
                    cc.geom_alpha_ranges.tolist(),
                    cc.geom_interpol_verts.tolist(),
                    [str(x.message) for x in w]))
        assert own["torch"][0] == own["jax"][0]
        assert own["torch"][1] == own["jax"][1]
        assert own["torch"][0][1], "nothing selected"


def test_geom_on_pod_vectorized_walks_the_modes_in_groups_of_p(tmp_path):
    """The quirk both packages keep: pod_vectorized components (K modes)
    with p = 2 are walked in groups of p, so K = 6 requested keeps 3
    components after a zero-residual truncation at the first empty group;
    picks [2 1 6] on ``synthetic_p_tensor(F=14, e=9, p=2)``."""
    out = {}
    for pkg in PACKAGES:
        cc = make_cc(pkg, tmp_path / pkg, synthetic_p_tensor(), K=6)
        cc.compute_components_store_singvalues()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cc.geom_block_form_utilizing_differential_operator(
                error_in_pos_space=False)
        out[pkg] = (cc.numComp, len(cc.comps), cc.geom_alpha.tolist(),
                    cc.geom_Pt.tolist(), [str(x.message) for x in w])
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == (3, 6, [2, 1, 6])
    assert "zero residual at component 3" in out["torch"][4][0]


@pytest.mark.parametrize("itype", ["deim", "deim_block_form", "geom"])
def test_geom_constructed_matches_jax(tmp_path, itype):
    """The reconstruction from the first r components and their rows, and
    its three errors, on the same components and selections: within
    1e-10."""
    out = {}
    for pkg in PACKAGES:
        cc = components(pkg, tmp_path / pkg, "tris",
                        interpolation_type=itype)
        cc.compute_components_store_singvalues()
        out[pkg] = cc
    a, b = out["jax"], out["torch"]
    b.comps = a.comps.copy()
    for cc in (a, b):
        if itype == "deim":
            cc.deim(device=False)
        elif itype == "deim_block_form":
            cc.numComp = 3
            cc.deim_blocksForm(device=False)
        else:
            cc.geom_block_form_utilizing_differential_operator(
                error_in_pos_space=True)
    np.testing.assert_array_equal(b.geom_Pt, a.geom_Pt)
    X = a.nonlinearSnapshots.snapTensor
    for r in (1, 2, 3):
        for case in ("train", "test"):
            ra, rb = a.geom_constructed(r, case), b.geom_constructed(r, case)
            np.testing.assert_allclose(rb, ra, rtol=0,
                                       atol=1e-10 * np.abs(X).max())
        f = X
        for name in ("frobenius_error", "relative_error_per_component",
                     "max_pointwise_error"):
            np.testing.assert_allclose(
                getattr(tcons.ConstraintComponents, name)(f, rb),
                getattr(jcons.ConstraintComponents, name)(f, ra),
                rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(b.test_basesSingVals(),
                               a.test_basesSingVals(), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# device_mesh_shards
# ---------------------------------------------------------------------------

def test_device_mesh_shards_warns_or_raises_as_jax_would_shard(
        tmp_path, monkeypatch):
    """A value of 2 with one device visible: both packages warn the same
    warning and compute on one device; 1 or less: no mesh and no warning;
    with two ranks visible the port builds a 2-rank ("model",) mesh and
    shards, as the JAX package does (the sharded run itself is held in
    tests/test_torch_parallel.py)."""
    import jax

    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    X = synthetic_p_tensor()
    for shards, warned in ((2, True), (1, False), (0, False)):
        msgs = {}
        for pkg in PACKAGES:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                cc = make_cc(pkg, tmp_path / pkg, X, device_mesh_shards=shards)
                cc.compute_components_store_singvalues()
            msgs[pkg] = [str(x.message) for x in w
                         if "device_mesh_shards" in str(x.message)]
        assert msgs["torch"] == msgs["jax"] and bool(msgs["torch"]) == warned
    from animsnapbases_tpu_torch.parallel import ensemble as tens

    with pytest.warns(UserWarning, match="only 1 devices are visible"):
        assert tens.mesh_from_shards(2, "cpu") is None
    built = []
    monkeypatch.setattr(tens, "visible_ranks", lambda: 2)
    monkeypatch.setattr(tens, "build_device_mesh",
                        lambda *a: built.append(a) or "mesh")
    assert tens.mesh_from_shards(2, "cpu") == "mesh"
    assert built == [((2,), ("model",), "cpu")]
