"""HDF5 animation and components schemas.

Copy of ``animsnapbases_tpu/io/h5anim.py``.  Animation files hold datasets
``verts`` (F, N, 3, float32) and ``tris`` (M, 3) plus optional attrs
``mean`` / ``scale`` from preprocessing; components files hold ``default``
(rest shape), ``tris``, and ``comp%03d`` datasets.  ``h5py`` is imported
by each function, never with the module: only ``.h5`` file I/O needs it.
"""

from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("h5py is required for .h5 animation I/O") from e
    return h5py


def write_animation_h5(path: str, verts: np.ndarray, tris: np.ndarray,
                       mean: np.ndarray | None = None,
                       scale: float | None = None,
                       compression: str | None = "gzip") -> None:
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f.create_dataset("verts", data=np.asarray(verts, np.float32),
                         compression=compression)
        f["tris"] = np.asarray(tris)
        if mean is not None:
            f.attrs["mean"] = np.asarray(mean)
        if scale is not None:
            f.attrs["scale"] = scale


def read_animation_h5(path: str):
    """Returns (verts (F,N,3) float64, tris, attrs dict)."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        verts = f["verts"][()].astype(float)
        tris = f["tris"][()]
        attrs = dict(f.attrs)
    return verts, tris, attrs


def write_components_h5(path: str, rest: np.ndarray, tris: np.ndarray,
                        components: np.ndarray) -> None:
    """components: (K, N, 3); stored as ``comp%03d`` datasets."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f["default"] = np.asarray(rest)
        f["tris"] = np.asarray(tris)
        for i, c in enumerate(np.asarray(components)):
            f[f"comp{i:03d}"] = c


def read_components_h5(path: str):
    """Returns (rest, tris, components (K,N,3), names)."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        tris = f["tris"][()]
        rest = f["default"][()]
        names = sorted(set(f.keys()) - {"tris", "default"})
        comps = np.array([f[name][()] for name in names])
    return rest, tris, comps, names
