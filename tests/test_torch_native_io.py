"""The port's native I/O (``io/native.py``: ``native/animio.cpp`` built by
g++ into ``build/native/``) and its ``.bin`` formats (``io/binfmt.py``)
against each other and against the JAX package's ``io/native.py`` and
``io/binfmt.py``: the readers return equal arrays, the writers write equal
bytes."""

import os

import numpy as np
import pytest

from animsnapbases_tpu.io import binfmt as jbin
from animsnapbases_tpu.io import native as jnative
from animsnapbases_tpu_torch.io import binfmt, meshes, native

RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def built():
    assert native.available(), "g++ is here: the native library must build"
    assert native.lib_path().parent.name == "native"
    assert native.lib_path().parent.parent.name == "build"
    return native


def off_frames(tmp_path, F=5, n=30):
    """F .off frames of one topology (the port's writer)."""
    faces = RNG.integers(0, n, size=(40, 3))
    paths, verts = [], []
    for f in range(F):
        v = RNG.normal(size=(n, 3))
        p = str(tmp_path / f"pos_{f}.off")
        meshes.save_off(p, v, faces)
        paths.append(p)
        verts.append(v)
    return paths, np.stack(verts), faces


def test_off_readers_agree(tmp_path, built):
    paths, verts, faces = off_frames(tmp_path)
    assert native.off_counts(paths[0]) == (30, 40)
    v, f = native.load_off(paths[0])
    pv, pf = meshes.load_off(paths[0])
    jv, jf = jnative.load_off(paths[0])
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(f, pf)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert f.dtype == np.int64
    V, F = native.load_off_sequence(paths, n_threads=2)
    JV, JF = jnative.load_off_sequence(paths)
    np.testing.assert_array_equal(V, JV)
    np.testing.assert_array_equal(F, JF)
    np.testing.assert_allclose(V, verts, atol=1e-12)


def test_fallbacks_equal_the_library(tmp_path, built, monkeypatch):
    """Without the library every entry point takes the Python reader or
    writer, with the same results."""
    paths, _, _ = off_frames(tmp_path)
    comps = RNG.normal(size=(4, 30, 3))
    with_lib = (native.load_off_sequence(paths),
                native.load_off(paths[0]))
    native.write_components_bin(str(tmp_path / "a.bin"), comps)
    native.write_vector_bin(str(tmp_path / "a_v.bin"), comps[0, :, 0])
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    without = (native.load_off_sequence(paths), native.load_off(paths[0]))
    for a, b in zip(with_lib, without):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    native.write_components_bin(str(tmp_path / "b.bin"), comps)
    native.write_vector_bin(str(tmp_path / "b_v.bin"), comps[0, :, 0])
    for a, b in (("a.bin", "b.bin"), ("a_v.bin", "b_v.bin")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    np.testing.assert_array_equal(
        native.read_components_bin(str(tmp_path / "a.bin"), 4, 30), comps)
    np.testing.assert_array_equal(
        native.read_vector_bin(str(tmp_path / "a_v.bin"), 30), comps[0, :, 0])


def test_components_and_vectors_byte_equal_to_jax(tmp_path, built):
    comps = RNG.normal(size=(5, 17, 3))
    v = RNG.normal(size=23)
    for tag, mod in (("port", native), ("jax", jnative)):
        mod.write_components_bin(str(tmp_path / f"{tag}.bin"), comps)
        mod.write_vector_bin(str(tmp_path / f"{tag}_v.bin"), v)
    jbin.write_components_bin(str(tmp_path / "py.bin"), comps)
    data = {(tmp_path / f).read_bytes() for f in ("port.bin", "jax.bin",
                                                  "py.bin")}
    assert len(data) == 1
    assert (tmp_path / "port_v.bin").read_bytes() == (
        tmp_path / "jax_v.bin").read_bytes()
    for reader in (native.read_components_bin, jnative.read_components_bin):
        np.testing.assert_array_equal(reader(str(tmp_path / "port.bin"), 5,
                                             17), comps)
    np.testing.assert_array_equal(
        native.read_vector_bin(str(tmp_path / "jax_v.bin"), 23), v)


def _pair(tmp_path, name):
    return str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")


def test_binfmt_writers_byte_equal_to_jax(tmp_path):
    """The nine functions the port adds: matrices, masses, vectors,
    column-major tensors and COO sparse matrices."""
    M = RNG.normal(size=(6, 4))
    m = RNG.uniform(1, 2, size=9)
    pts = RNG.normal(size=11)
    T = RNG.normal(size=(7, 5, 3))
    rows, cols = RNG.integers(0, 6, 20), RNG.integers(0, 8, 20)
    vals = RNG.normal(size=20)
    for ext in (".bin", ".npy"):
        a, b = _pair(tmp_path, "mat")
        pa = binfmt.write_matrix(a, M, ext)
        pb = jbin.write_matrix(b, M, ext)
        assert open(pa, "rb").read() == open(pb, "rb").read()
        a, b = _pair(tmp_path, "vec")
        pa, pb = binfmt.write_vector(a, pts, ext), jbin.write_vector(b, pts,
                                                                     ext)
        assert pa.endswith(f"_11{ext}")
        assert open(pa, "rb").read() == open(pb, "rb").read()
    with pytest.raises(ValueError):
        binfmt.write_matrix(str(tmp_path / "x"), M, ".txt")
    np.testing.assert_array_equal(
        binfmt.read_matrix_bin(str(tmp_path / "port_mat.bin")), M)
    np.testing.assert_array_equal(
        jbin.read_matrix_bin(str(tmp_path / "port_mat.bin")), M)
    a, b = _pair(tmp_path, "m.bin")
    binfmt.write_masses_bin(a, m)
    jbin.write_masses_bin(b, m)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(binfmt.read_masses_bin(b), m)
    a, b = _pair(tmp_path, "t.bin")
    binfmt.write_tensor_colmajor(a, T)
    jbin.write_tensor_colmajor(b, T)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(binfmt.read_tensor_colmajor(b), T)
    with pytest.raises(ValueError, match="N, Kp, 3"):
        binfmt.write_tensor_colmajor(a, T[:, :, :2])
    a, b = _pair(tmp_path, "s.bin")
    binfmt.write_sparse_bin(a, 6, 8, rows, cols, vals)
    jbin.write_sparse_bin(b, 6, 8, rows, cols, vals)
    assert open(a, "rb").read() == open(b, "rb").read()
    r, c, ri, ci, v = binfmt.read_sparse_bin(b)
    assert (r, c) == (6, 8)
    np.testing.assert_array_equal(ri, rows)
    np.testing.assert_array_equal(ci, cols)
    np.testing.assert_array_equal(v, vals)
    S = binfmt.read_sparse_scipy(a)
    assert (S != jbin.read_sparse_scipy(b)).nnz == 0
    assert S.shape == (6, 8)


def test_library_is_built_under_build_not_native():
    """The port never writes into ``native/``, where the JAX package's
    library lives."""
    assert native.SOURCE.parent.name == "native"
    assert native.BUILD_DIR != native.SOURCE.parent
    assert os.path.basename(str(native.lib_path())).startswith("libanimio_")
