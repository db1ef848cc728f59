"""Little-endian binary formats of the bases pipeline.

Copy of ``animsnapbases_tpu/io/binfmt.py`` (numpy only): the components
``.bin`` writer and reader, the interpolation-points and plain vectors, the
matrices, masses, column-major tensors and COO sparse matrices, each
byte-compatible with the reference's files.

components ``.bin``
    header:  int32 N, int32 dim*K
    payload: float64 values ordered d-major, then k, then i
    filename grammar: ``{base}F{F}{colName}{K}.bin`` with colName 'K' or 'Kp'.

interpolation-points vector ``.bin``
    header:  int32 npoints, int32 1
    payload: npoints float64
    filename grammar: ``{base}F{F}{colName}{K}_points{npoints}.bin``

plain vector ``.bin``
    header:  int32 npoints, int32 1; payload npoints float64
    filename grammar: ``{base}_{npoints}.bin``

matrix ``.bin``
    header:  int32 cols, int32 rows; payload rows*cols float64, C order

masses ``.bin``
    header:  int32 n, int32 m; payload n float64

column-major tensor ``.bin``
    header:  uint32 N, Kp, 3; payload float64 in Fortran order

sparse ``.bin``
    header:  int32 rows, cols, nnz; payload nnz (int32 row, int32 col,
    float64 value) records
"""

from __future__ import annotations

import struct

import numpy as np

_F64 = np.dtype("<f8")
_U32 = np.dtype("<u4")


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


def write_vector(base: str, points: np.ndarray,
                 extension: str = ".bin") -> str:
    """A plain vector as ``{base}_{n}.bin`` (or ``.npy``) -> its path."""
    points = np.asarray(points)
    n = points.shape[0]
    if extension == ".bin":
        path = f"{base}_{n}.bin"
        _write_header_vector(path, points)
        return path
    if extension == ".npy":
        path = f"{base}_{n}.npy"
        np.save(path, points)
        return path
    raise ValueError(f"unknown vector extension: {extension}")


# ---------------------------------------------------------------------------
# matrices / masses / tensors
# ---------------------------------------------------------------------------

def write_matrix(base: str, mat: np.ndarray, extension: str = ".bin") -> str:
    """A (rows, cols) matrix as ``{base}.bin`` (or ``.npy``) -> its path."""
    mat = np.asarray(mat, dtype=np.float64)
    d1, d2 = mat.shape
    if extension == ".bin":
        path = base + ".bin"
        with open(path, "wb") as f:
            f.write(struct.pack("<ii", d2, d1))
            f.write(np.ascontiguousarray(mat).astype(_F64).tobytes())
        return path
    if extension == ".npy":
        path = base + ".npy"
        np.save(path, mat)
        return path
    raise ValueError(f"unknown matrix extension: {extension}")


def read_matrix_bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        d2, d1 = struct.unpack("<ii", f.read(8))
        return np.frombuffer(f.read(8 * d1 * d2),
                             dtype=_F64).reshape(d1, d2).copy()


def write_masses_bin(path: str, masses: np.ndarray) -> None:
    """An n-vector of vertex or element masses: (n, 1) header, n
    doubles."""
    masses = np.asarray(masses, dtype=np.float64)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", masses.shape[0], 1))
        f.write(masses.astype(_F64).tobytes())


def read_masses_bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, _ = struct.unpack("<ii", f.read(8))
        return np.frombuffer(f.read(8 * n), dtype=_F64).copy()


def write_tensor_colmajor(path: str, tensor: np.ndarray) -> None:
    """An (N, Kp, 3) tensor: uint32 dims header, Fortran-order float64
    payload."""
    tensor = np.asarray(tensor, dtype=np.float64)
    if tensor.ndim != 3 or tensor.shape[2] != 3:
        raise ValueError("tensor must be (N, Kp, 3)")
    with open(path, "wb") as f:
        f.write(np.array(tensor.shape, dtype=_U32).tobytes())
        f.write(np.asfortranarray(tensor).tobytes(order="F"))


def read_tensor_colmajor(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, kp, c = np.frombuffer(f.read(12), dtype=_U32)
        data = np.frombuffer(f.read(int(8 * n * kp * c)), dtype=_F64)
    return data.reshape((n, kp, c), order="F").copy()


# ---------------------------------------------------------------------------
# sparse COO
# ---------------------------------------------------------------------------

_COO_REC = np.dtype([("row", "<i4"), ("col", "<i4"), ("val", "<f8")])


def write_sparse_bin(path: str, rows: int, cols: int,
                     row_idx: np.ndarray, col_idx: np.ndarray,
                     values: np.ndarray) -> None:
    """A COO sparse matrix as interleaved (int32 row, int32 col, float64
    value) records."""
    nnz = len(values)
    rec = np.empty(nnz, dtype=_COO_REC)
    rec["row"] = row_idx
    rec["col"] = col_idx
    rec["val"] = values
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", rows, cols, nnz))
        f.write(rec.tobytes())


def read_sparse_bin(path: str):
    """-> (rows, cols, row_idx, col_idx, values)."""
    with open(path, "rb") as f:
        rows, cols, nnz = struct.unpack("<iii", f.read(12))
        rec = np.frombuffer(f.read(16 * nnz), dtype=_COO_REC)
    return rows, cols, rec["row"].copy(), rec["col"].copy(), rec["val"].copy()


def read_sparse_scipy(path: str):
    """The COO ``.bin`` as a scipy CSR matrix."""
    from scipy.sparse import csr_matrix

    rows, cols, r, c, v = read_sparse_bin(path)
    return csr_matrix((v, (r, c)), shape=(rows, cols))
