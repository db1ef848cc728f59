"""ctypes bindings to the native I/O runtime (``native/animio.cpp``).

Counterpart of ``animsnapbases_tpu/io/native.py``: a threaded ``.off``
reader and the ``.bin`` component and vector writers and readers, each
with a Python fallback of the same result.  The C++ source is the JAX
package's, unedited; the port builds it at first use with the flags of
``native/Makefile`` (``g++ -O3 -std=c++17 -fPIC -shared -pthread``) into
``build/native/`` at the repository root, under a name that carries a hash
of the source, so an edited source is rebuilt and a stale library never
loaded.  The build is written under a temporary name and renamed into
place, so processes that build at once never load a half-written file.
:func:`available` says whether the library built and loaded; without a
compiler every entry point takes its fallback.  Nothing here builds when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "animio.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    """The library's path: ``build/native/libanimio_<hash>.so``."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libanimio_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        str(SOURCE)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.exists():
            return None
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        i32 = ctypes.c_int32
        lib.anim_off_counts.argtypes = [ctypes.c_char_p, i64p, i64p]
        lib.anim_load_off.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int64, dp, ip]
        lib.anim_load_off_sequence.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            dp, ip, ctypes.c_int]
        lib.anim_write_components_bin.argtypes = [ctypes.c_char_p, dp, i32,
                                                  i32, i32]
        lib.anim_read_components_bin.argtypes = [ctypes.c_char_p, dp, i32,
                                                 i32, i32]
        lib.anim_write_vector_bin.argtypes = [ctypes.c_char_p, dp, i32]
        lib.anim_read_vector_bin.argtypes = [ctypes.c_char_p, dp, i32]
        for fn in (lib.anim_off_counts, lib.anim_load_off,
                   lib.anim_load_off_sequence, lib.anim_write_components_bin,
                   lib.anim_read_components_bin, lib.anim_write_vector_bin,
                   lib.anim_read_vector_bin):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def off_counts(path: str):
    """(vertices, faces) in the header of an ``.off`` file; needs the
    library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.anim_off_counts(str(path).encode(), ctypes.byref(nv),
                             ctypes.byref(nf))
    if rc != 0:
        raise IOError(f"anim_off_counts({path}) failed rc={rc}")
    return int(nv.value), int(nf.value)


def load_off(path: str):
    """Native ``.off`` reader -> (verts (n, 3) float64, faces (m, 3)
    int64); the Python reader without the library."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.meshes import load_off as py_load
        return py_load(path)
    nv, nf = off_counts(path)
    verts = np.empty((nv, 3), dtype=np.float64)
    faces = np.empty((nf, 3), dtype=np.int32)
    rc = lib.anim_load_off(str(path).encode(), nv, nf, _dptr(verts),
                           _iptr(faces))
    if rc != 0:
        raise IOError(f"anim_load_off({path}) failed rc={rc}")
    return verts, faces.astype(np.int64)


def load_off_sequence(paths: list[str], n_threads: int = 0):
    """Thread-pooled reader of ``.off`` frames of one topology -> (verts
    (F, n, 3) float64, faces (m, 3) int64); a Python loop without the
    library."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.meshes import load_off as py_load
        frames = [py_load(p) for p in paths]
        return (np.stack([v for v, _ in frames]),
                np.asarray(frames[0][1], dtype=np.int64))
    nv, nf = off_counts(paths[0])
    F = len(paths)
    verts = np.empty((F, nv, 3), dtype=np.float64)
    faces = np.empty((nf, 3), dtype=np.int32)
    joined = "\n".join(str(p) for p in paths).encode()
    rc = lib.anim_load_off_sequence(joined, F, nv, nf, _dptr(verts),
                                    _iptr(faces), n_threads)
    if rc != 0:
        raise IOError(f"anim_load_off_sequence failed rc={rc}")
    return verts, faces.astype(np.int64)


def write_components_bin(path: str, bases: np.ndarray):
    """A (K, N, dim) bases tensor in the components ``.bin`` layout."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.binfmt import write_components_bin
        return write_components_bin(path, bases)
    bases = np.ascontiguousarray(bases, dtype=np.float64)
    K, N, dim = bases.shape
    rc = lib.anim_write_components_bin(str(path).encode(), _dptr(bases), K,
                                       N, dim)
    if rc != 0:
        raise IOError(f"anim_write_components_bin({path}) rc={rc}")


def read_components_bin(path: str, K: int, N: int, dim: int = 3):
    """A components ``.bin`` back to (K, N, dim) float64."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.binfmt import read_components_bin
        return read_components_bin(path, K=K, dim=dim)
    out = np.empty((K, N, dim), dtype=np.float64)
    rc = lib.anim_read_components_bin(str(path).encode(), _dptr(out), K, N,
                                      dim)
    if rc != 0:
        raise IOError(f"anim_read_components_bin({path}) rc={rc}")
    return out


def write_vector_bin(path: str, v: np.ndarray):
    """An n-vector with the (n, 1) header of the masses ``.bin``."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.binfmt import write_masses_bin
        return write_masses_bin(path, v)
    v = np.ascontiguousarray(v, dtype=np.float64)
    rc = lib.anim_write_vector_bin(str(path).encode(), _dptr(v), len(v))
    if rc != 0:
        raise IOError(f"anim_write_vector_bin({path}) rc={rc}")


def read_vector_bin(path: str, n: int):
    """An (n, 1)-headed vector ``.bin`` back to n float64 values."""
    lib = _load()
    if lib is None:
        from animsnapbases_tpu_torch.io.binfmt import read_masses_bin
        return read_masses_bin(path)
    out = np.empty(n, dtype=np.float64)
    rc = lib.anim_read_vector_bin(str(path).encode(), _dptr(out), n)
    if rc != 0:
        raise IOError(f"anim_read_vector_bin({path}) rc={rc}")
    return out
