"""``bar``: a tetrahedral bar of ``size`` = (width, height, depth) vertices.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3,
of ``animsnapbases_tpu_torch/geometry/procedural.py`` ``bar_model`` and
``geometry/mesh.py`` ``boundary_facets`` (the same vertex, tet and face
order, so that the element indices of the bases name the same elements in
the program's model) and of ``chip_smoke.py`` ``bar_scene`` and
``rescale``, rewritten to return arrays: scaled to a unit extent, centred,
lifted ``lift`` along y.  It has no pins of its own: a configuration pins
its ends by the scene's ``pins`` rule (``scene.py``).
"""

from __future__ import annotations

import numpy as np


def boundary_facets(tets: np.ndarray) -> np.ndarray:
    tets = np.asarray(tets, dtype=np.int64)
    faces = np.concatenate([tets[:, [1, 2, 3]], tets[:, [0, 3, 2]],
                            tets[:, [0, 1, 3]], tets[:, [0, 2, 1]]])
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]


def bar_grid(width: int, height: int, depth: int):
    """Tetrahedral bar, 5 tets a cell, parity-alternated -> (V, T, F)."""
    V = np.zeros((width * height * depth, 3))

    def idx(i, j, k):
        return i * height * depth + j * depth + k

    for i in range(width):
        for j in range(height):
            for k in range(depth):
                V[idx(i, j, k)] = (float(i), float(j), float(k))
    tets = []
    for i in range(width - 1):
        for j in range(height - 1):
            for k in range(depth - 1):
                p0, p1 = idx(i, j, k), idx(i + 1, j, k)
                p2, p3 = idx(i + 1, j + 1, k), idx(i, j + 1, k)
                p4, p5 = idx(i, j, k + 1), idx(i + 1, j, k + 1)
                p6, p7 = idx(i + 1, j + 1, k + 1), idx(i, j + 1, k + 1)
                if (i + j + k) % 2 == 1:
                    tets += [[p1, p0, p5, p2], [p5, p2, p7, p6],
                             [p7, p0, p5, p4], [p2, p0, p7, p3],
                             [p5, p0, p7, p2]]
                else:
                    tets += [[p3, p1, p4, p0], [p6, p1, p3, p2],
                             [p4, p1, p6, p5], [p6, p3, p4, p7],
                             [p3, p1, p6, p4]]
    T = np.asarray(tets, dtype=np.int64)
    F = boundary_facets(T)
    return V, T[:, ::-1].copy(), F[:, ::-1].copy()


def build(spec):
    V, T, F = bar_grid(*spec["size"])
    V = V - V.min(axis=0)
    extent = (V.max(axis=0) - V.min(axis=0)).max()
    V = V / extent - 0.5
    V[:, 1] += float(spec["lift"])
    return V, F, T, np.zeros(len(V), dtype=bool)
