"""The geometry and I/O of the port's position workflow
(``geometry/{mesh,laplacian,geodesics,procrustes,partitioning,volume}.py``,
``io/{meshes,h5anim,binfmt}.py``) against the JAX package, float64 on the
CPU, on the same numpy inputs.

Tolerances: the Laplacian and vertex areas 1e-12, geodesics 1e-10 (two
sparse LU solves), generic Procrustes alignments 1e-12, winding numbers
1e-12; topology, seeds, labels, tets and files exactly.  Where frame 0 is
planar, the cross-covariance m of the Procrustes problem has rank 2 and
the sign of its third singular pair is arbitrary: the port's answer is
the one with det(u @ vt) = +1, one of the two answers the JAX code can
give (both worked out here with numpy), and JAX's own where its SVD gave
det(u @ vt) = +1 (ROADMAP Queue C).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animsnapbases_tpu.geometry import geodesics as jgeo
from animsnapbases_tpu.geometry import laplacian as jlap
from animsnapbases_tpu.geometry import mesh as jmesh
from animsnapbases_tpu.geometry import partitioning as jpart
from animsnapbases_tpu.geometry import procrustes as jproc
from animsnapbases_tpu.geometry import volume as jvol
from animsnapbases_tpu.geometry.procedural import bar_model as jax_bar_model
from animsnapbases_tpu.io import binfmt as jbin
from animsnapbases_tpu.io import h5anim as jh5
from animsnapbases_tpu.io import meshes as jmeshes
from animsnapbases_tpu_torch.geometry import geodesics, laplacian, mesh
from animsnapbases_tpu_torch.geometry import partitioning, procrustes, volume
from animsnapbases_tpu_torch.geometry.procedural import (
    bar_model,
    bar_surface_mesh,
    cloth_model,
)
from animsnapbases_tpu_torch.io import binfmt, h5anim, meshes


def bent_cloth(rows=6, cols=6, seed=0):
    """A cloth with a smooth out-of-plane bend (non-planar, no zero
    area)."""
    V, F = cloth_model(rows, cols)
    V = np.asarray(V, dtype=float).copy()
    amp = np.random.default_rng(seed).normal(size=2)
    V[:, 2] += 0.3 * (amp[0] * np.sin(V[:, 0]) + amp[1] * np.cos(V[:, 1]))
    return V, F


# ---------------------------------------------------------------------------
# Laplacian, vertex areas, geodesics
# ---------------------------------------------------------------------------

def test_laplacian_and_vertex_areas_match_jax():
    V, F = bent_cloth()
    L, VA = laplacian.cotan_laplacian(V, F)
    Lj, VAj = jlap.cotan_laplacian(V, F)
    assert abs(L - Lj).max() <= 1e-12 * abs(Lj).max()
    np.testing.assert_allclose(VA.diagonal(), VAj.diagonal(), rtol=1e-12,
                               atol=0)
    for a, b in zip(laplacian.laplacian_coo(V, F), jlap.laplacian_coo(V, F)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("scene", ["flat grid", "6x6 cloth"])
def test_geodesics_match_jax(scene):
    V, F = cloth_model(9, 9) if scene == "flat grid" else bent_cloth()
    gd, gj = geodesics.GeodesicDistance(V, F), jgeo.GeodesicDistance(V, F)
    for src in (0, [3, 7], np.arange(len(V)) == len(V) // 2):
        a, b = gd(src), gj(src)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 * np.abs(b).max())


# ---------------------------------------------------------------------------
# Procrustes
# ---------------------------------------------------------------------------

def _frames(planar, seed):
    """Six frames of 20 points: frame 0 planar (z = 20) or not, the others
    bent copies of it moved by random rotations and translations."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(20, 3))
    if planar:
        base[:, 2] = 20.0
    frames = [base]
    for _ in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        bent = base + 0.3 * rng.normal(size=base.shape)
        frames.append(bent @ q.T + rng.normal(size=3))
    return np.stack(frames)


def _jax_aligned(V, rigid):
    fn = jproc._align_rigid if rigid else jproc._align_centered
    return np.asarray(fn(jnp.asarray(V)))


def _both_answers(frm, to, rigid):
    """The two answers of JAX's rule under either sign of the third
    singular pair of m (numpy), the det(u @ vt) = +1 one first."""
    t0, t1 = frm.mean(axis=0), to.mean(axis=0)
    u, _, vt = np.linalg.svd((to - t1).T @ (frm - t0))
    out = []
    for sign in (1.0, -1.0):
        u2 = u * np.array([1.0, 1.0, sign])
        r = u2 @ vt
        if np.linalg.det(r) < 0:
            r = -r
        t = t1 - r @ t0
        out.append(frm @ r.T + t if rigid else frm + t)
    if np.linalg.det(u @ vt) < 0:
        out = out[::-1]
    return out, np.linalg.det(u @ vt) > 0


@pytest.mark.parametrize("rigid", [True, False], ids=["rigid", "centered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_procrustes_generic_frames_match_jax(rigid, seed):
    V = _frames(False, seed)
    got = procrustes.align_frames(torch.as_tensor(V), rigid).numpy()
    np.testing.assert_allclose(got, _jax_aligned(V, rigid), rtol=0,
                               atol=1e-12 * np.abs(V).max())
    out = procrustes.align_animation(V, rigid, device="cpu")
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, got.astype(np.float32))


@pytest.mark.parametrize("rigid", [True, False], ids=["rigid", "centered"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_procrustes_planar_frame0_takes_the_det_plus_answer(rigid, seed):
    V = _frames(True, seed)
    got = procrustes.align_frames(torch.as_tensor(V), rigid).numpy()
    jax_out = _jax_aligned(V, rigid)
    tol = 1e-12 * np.abs(V).max()
    same_as_jax = 0
    for i in range(len(V)):
        (plus, minus), jax_plus = _both_answers(V[i], V[0], rigid)
        np.testing.assert_allclose(got[i], plus, rtol=0, atol=tol)
        # JAX gives one of the two answers: its own where its u @ vt had
        # det +1
        assert (np.abs(jax_out[i] - plus).max() <= tol
                or np.abs(jax_out[i] - minus).max() <= tol)
        if jax_plus:
            np.testing.assert_allclose(got[i], jax_out[i], rtol=0, atol=tol)
            same_as_jax += 1
    # frame 0 onto itself is the identity, the translation zero
    np.testing.assert_allclose(got[0], V[0], rtol=0, atol=tol)
    assert same_as_jax >= 1


# ---------------------------------------------------------------------------
# mesh helpers and file I/O
# ---------------------------------------------------------------------------

def test_mesh_helpers_match_jax():
    V, F = bent_cloth(5, 5)
    # a second, smaller component and a degenerate triangle
    V2 = np.concatenate([V, V[:3] + 10.0])
    F2 = np.concatenate([F, [[25, 26, 27], [0, 0, 1]]])
    n = len(V2)
    np.testing.assert_array_equal(mesh.connected_components_labels(n, F2),
                                  jmesh.connected_components_labels(n, F2))
    keep = mesh.largest_component_mask(n, F2)
    np.testing.assert_array_equal(keep, jmesh.largest_component_mask(n, F2))
    np.testing.assert_array_equal(mesh.filter_reindex(keep, F),
                                  jmesh.filter_reindex(keep, F))
    with pytest.raises(ValueError):
        mesh.filter_reindex(keep.astype(int), F)
    np.testing.assert_array_equal(mesh.triangle_areas(V2, F2),
                                  jmesh.triangle_areas(V2, F2))


def test_mesh_files_and_h5_match_jax(tmp_path):
    V, F = bent_cloth(4, 4)
    off = str(tmp_path / "a.off")
    meshes.save_off(off, V, F)
    jmeshes.save_off(str(tmp_path / "j.off"), V, F)
    assert open(off).read() == open(str(tmp_path / "j.off")).read()
    for a, b in zip(meshes.load_off(off), jmeshes.load_off(off)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(meshes.load_mesh_auto(off), jmeshes.load_mesh_auto(off)):
        np.testing.assert_array_equal(a, b)
    ply = tmp_path / "a.ply"
    ply.write_text("ply\nformat ascii 1.0\ncomment x\nelement vertex 4\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   "element face 1\nproperty list uchar int vertex_index\n"
                   "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0.5\n4 0 1 2 3\n")
    for a, b in zip(meshes.load_mesh_auto(str(ply)),
                    jmeshes.load_ply(str(ply))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        meshes.load_mesh_auto(str(tmp_path / "a.stl"))

    # .h5: the port's files read by the JAX package and back
    anim = np.stack([V, V + 0.1])
    h5 = str(tmp_path / "anim.h5")
    h5anim.write_animation_h5(h5, anim, F, mean=np.ones(3), scale=2.0)
    jv, jt, ja = jh5.read_animation_h5(h5)
    tv, tt, ta = h5anim.read_animation_h5(h5)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jt, tt)
    assert ja["scale"] == ta["scale"] == 2.0
    comps = np.random.default_rng(0).normal(size=(3, len(V), 3))
    h5anim.write_components_h5(str(tmp_path / "c.h5"), V, F, comps)
    for a, b in zip(jh5.read_components_h5(str(tmp_path / "c.h5")),
                    h5anim.read_components_h5(str(tmp_path / "c.h5"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # .bin readers
    path = binfmt.write_components(str(tmp_path / "q_"), 7, 3, len(V), 3,
                                   comps)
    np.testing.assert_array_equal(binfmt.read_components_bin(path, K=3),
                                  jbin.read_components_bin(path, K=3))
    np.testing.assert_array_equal(binfmt.read_components_bin(path), comps)
    with pytest.raises(ValueError):
        binfmt.read_components_bin(path, K=2)
    jbin.write_masses_bin(str(tmp_path / "m.bin"), np.arange(5.0))
    np.testing.assert_array_equal(
        binfmt.read_masses_bin(str(tmp_path / "m.bin")), np.arange(5.0))


# ---------------------------------------------------------------------------
# partitioning and volume
# ---------------------------------------------------------------------------

def test_partitioning_seeds_and_labels_match_jax():
    V, F = bent_cloth(8, 8)
    seeds, dmin = partitioning.surface_seeds_heat(V, F, 4)
    jseeds, jdmin = jpart.surface_seeds_heat(V, F, 4)
    np.testing.assert_array_equal(seeds, jseeds)
    np.testing.assert_allclose(dmin, jdmin, rtol=0,
                               atol=1e-10 * np.abs(jdmin).max())
    labels, D = partitioning.geodesic_labels_surface_from_seeds(V, F, seeds)
    jlabels, _ = jpart.geodesic_labels_surface_from_seeds(V, F, seeds)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(
        partitioning.graph_distance(V, mesh.unique_edges(F), [0, 5]),
        jpart.graph_distance(V, jmesh.unique_edges(F), [0, 5]))

    Vb, T, _, _ = bar_model(4, 2, 2)
    np.testing.assert_array_equal(Vb, jax_bar_model(4, 2, 2)[0])
    st, _ = partitioning.tet_seeds_heat(Vb, T, 3)
    np.testing.assert_array_equal(st, jpart.tet_seeds_heat(Vb, T, 3)[0])
    lt, Dt = partitioning.geodesic_labels_tet_from_seeds(Vb, T, st)
    jlt, jDt = jpart.geodesic_labels_tet_from_seeds(Vb, T, st)
    np.testing.assert_array_equal(lt, jlt)
    for rule in ("mode", "mean", "min"):
        np.testing.assert_array_equal(
            partitioning.tet_labels_from_vertex_labels(T, lt, Dt, rule),
            jpart.tet_labels_from_vertex_labels(T, jlt, jDt, rule))


def test_winding_numbers_and_tetrahedralize_match_jax():
    V, F = bar_surface_mesh(3, 2, 2)
    V = np.asarray(V, dtype=float)
    F2 = volume.orient_faces_consistently(F)
    np.testing.assert_array_equal(F2, jvol.orient_faces_consistently(F))
    pts = np.random.default_rng(0).uniform(-1.0, 4.0, size=(40, 3))
    w = volume.winding_number(V, F2, pts, max_pairs=200)
    np.testing.assert_allclose(w, jvol.winding_number(V, F2, pts), rtol=0,
                               atol=1e-12)
    TV, IT, Fb = volume.tetrahedralize(V, F)
    jTV, jIT, jFb = jvol.tetrahedralize(V, F)
    assert len(IT) > 0
    for a, b in ((TV, jTV), (IT, jIT), (Fb, jFb)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(volume.tet_quality(TV, IT),
                                  jvol.tet_quality(jTV, jIT))
