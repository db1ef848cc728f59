"""Procedural meshes: the tetrahedral bar and the cloth grid.

Counterpart of ``animsnapbases_tpu/geometry/procedural.py``: ``bar_model``,
``bar_surface_mesh``, ``bar_model_surface_tetrahedralized`` and
``cloth_model``, with the same vertex order and
winding, so a scene built here and one built by the JAX package are the
same scene.
"""

from __future__ import annotations

import numpy as np

from animsnapbases_tpu_torch.geometry.mesh import boundary_facets


def bar_model(width: int, height: int, depth: int):
    """Tetrahedral bar on a vertex grid, 5 tets per cell with a
    parity-alternated decomposition.  Returns (V, T, F, V_surface), with
    the reversed winding of T and F of the reference generator."""
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
                p0 = idx(i, j, k)
                p1 = idx(i + 1, j, k)
                p2 = idx(i + 1, j + 1, k)
                p3 = idx(i, j + 1, k)
                p4 = idx(i, j, k + 1)
                p5 = idx(i + 1, j, k + 1)
                p6 = idx(i + 1, j + 1, k + 1)
                p7 = idx(i, j + 1, k + 1)
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
    T = T[:, ::-1]
    F = F[:, ::-1]
    surface_idx = np.unique(F.flatten())
    return V, T, F, V[surface_idx]


def bar_model_surface_tetrahedralized(width: int, height: int, depth: int):
    """The surface grid of :func:`bar_surface_mesh` fed through
    ``geometry/volume.py``'s ``tetrahedralize`` (the reference's
    tetgen-based variant).  Returns (V, T, F)."""
    from animsnapbases_tpu_torch.geometry.volume import tetrahedralize

    V, F = bar_surface_mesh(width, height, depth)
    return tetrahedralize(V, F)


def bar_surface_mesh(width: int, height: int, depth: int):
    """Surface-only cuboid grid mesh: the grid's boundary vertices, its
    quads split into triangles.  Returns (V, F)."""
    grid = np.array([
        [i, j, k]
        for i in range(width)
        for j in range(height)
        for k in range(depth)
        if i in (0, width - 1) or j in (0, height - 1) or k in (0, depth - 1)
    ], dtype=float)
    lookup = {tuple(p): n for n, p in enumerate(grid)}
    faces = []

    def add_quad(quad):
        keys = [tuple(map(float, p)) for p in quad]
        if all(k in lookup for k in keys):
            p0, p1, p2, p3 = (lookup[k] for k in keys)
            faces.append([p0, p1, p2])
            faces.append([p0, p2, p3])

    for i in range(width - 1):
        for j in range(height - 1):
            for k in (0, depth - 1):
                add_quad([[i, j, k], [i + 1, j, k], [i + 1, j + 1, k],
                          [i, j + 1, k]])
    for i in range(width - 1):
        for k in range(depth - 1):
            for j in (0, height - 1):
                add_quad([[i, j, k], [i + 1, j, k], [i + 1, j, k + 1],
                          [i, j, k + 1]])
    for j in range(height - 1):
        for k in range(depth - 1):
            for i in (0, width - 1):
                add_quad([[i, j, k], [i, j + 1, k], [i, j + 1, k + 1],
                          [i, j, k + 1]])
    return grid, np.asarray(faces, dtype=np.int64)


def cloth_model(rows: int, cols: int):
    """Flat cloth grid in the XY plane; two triangles per cell, reference
    winding. Returns (V, F)."""
    verts = []
    faces = []
    for i in range(rows):
        for j in range(cols):
            verts.append([float(i), float(j), 0.0])
            if i == rows - 1 or j == cols - 1:
                continue
            ll = i * cols + j
            ul = i * cols + (j + 1)
            lr = (i + 1) * cols + j
            ur = (i + 1) * cols + (j + 1)
            faces.append([ll, ur, ul])
            faces.append([ll, lr, ur])
    return np.asarray(verts), np.asarray(faces, dtype=np.int64)
