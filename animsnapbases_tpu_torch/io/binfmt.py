"""Little-endian binary formats of the bases pipeline.

Copy of the parts of ``animsnapbases_tpu/io/binfmt.py`` that the bases
pipeline reaches (numpy only): the components ``.bin`` writer and reader,
the interpolation-points vector writer and reader and the masses reader,
byte-compatible with the reference's files.

components ``.bin``
    header:  int32 N, int32 dim*K
    payload: float64 values ordered d-major, then k, then i
    filename grammar: ``{base}F{F}{colName}{K}.bin`` with colName 'K' or 'Kp'.

interpolation-points vector ``.bin``
    header:  int32 npoints, int32 1
    payload: npoints float64
    filename grammar: ``{base}F{F}{colName}{K}_points{npoints}.bin``

masses ``.bin``
    header:  int32 n, int32 m; payload n float64
"""

from __future__ import annotations

import struct

import numpy as np

_F64 = np.dtype("<f8")


def components_bin_name(base: str, F: int, K: int, col_name: str = "K") -> str:
    """Filename grammar of the reference components writer."""
    return f"{base}F{F}{col_name}{K}.bin"


def components_npy_name(base: str, F: int, K: int) -> str:
    return f"{base}{F}K{K}.npy"


def write_components_bin(path: str, bases: np.ndarray) -> None:
    """Write a (K, N, dim) bases tensor in the reference .bin layout."""
    bases = np.asarray(bases, dtype=np.float64)
    K, N, dim = bases.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", N, dim * K))
        # d-major, then k, then i  ==  transpose to (dim, K, N) C-order
        f.write(np.ascontiguousarray(bases.transpose(2, 0, 1)).astype(_F64).tobytes())


def read_components_bin(path: str, K: int | None = None,
                        dim: int = 3) -> np.ndarray:
    """Read a components .bin back to (K, N, dim)."""
    with open(path, "rb") as f:
        N, dimK = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(), dtype=_F64)
    if K is None:
        K = dimK // dim
    if dim * K != dimK:
        raise ValueError(f"dim*K mismatch: {dim}*{K} != {dimK}")
    return data.reshape(dim, K, N).transpose(1, 2, 0)


def write_components(base: str, F: int, K: int, N: int, dim: int,
                     bases: np.ndarray, extension: str = ".bin",
                     col_name: str = "K") -> str:
    """Mirror of the reference ``store_components`` dispatch (.bin / .npy),
    including the filename grammar. Returns the written path."""
    assert bases.shape == (K, N, dim)
    if extension == ".bin":
        path = components_bin_name(base, F, K, col_name)
        write_components_bin(path, bases)
        return path
    if extension == ".npy":
        path = components_npy_name(base, F, K)
        np.save(path, bases)
        return path
    raise ValueError(f"unknown components extension: {extension}")


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------


def points_vector_name(base: str, F: int, K: int, npoints: int,
                       col_name: str = "K") -> str:
    return f"{base}F{F}{col_name}{K}_points{npoints}.bin"


def write_points_vector(base: str, F: int, K: int, points: np.ndarray,
                        extension: str = ".bin", col_name: str = "K") -> str:
    """Interpolation-points vector with reference filename grammar."""
    points = np.asarray(points)
    n = points.shape[0]
    assert K <= n
    if extension == ".bin":
        path = points_vector_name(base, F, K, n, col_name)
        _write_header_vector(path, points)
        return path
    if extension == ".npy":
        path = f"{base}{F}K{K}_points{n}.npy"
        np.save(path, points)
        return path
    raise ValueError(f"unknown points extension: {extension}")


def _write_header_vector(path: str, values: np.ndarray) -> None:
    values = np.asarray(values, dtype=np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", values.shape[0], 1))
        f.write(values.astype(_F64).tobytes())


def read_points_vector(path: str) -> np.ndarray:
    """Read any (n, 1)-headed vector ``.bin`` (points or plain vector)."""
    with open(path, "rb") as f:
        n, _ = struct.unpack("<ii", f.read(8))
        return np.frombuffer(f.read(8 * n), dtype=_F64).copy()


def read_masses_bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, _ = struct.unpack("<ii", f.read(8))
        return np.frombuffer(f.read(8 * n), dtype=_F64).copy()
