"""``cloth``: a square grid of ``rows`` x ``rows`` vertices, hung.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3,
of ``animsnapbases_tpu_torch/geometry/procedural.py`` ``cloth_model`` (the
same vertex and face order, so that the element indices of the bases name
the same elements in the program's model) and of ``bases/pipeline.py``
``bench_model`` (the bench cloth), rewritten to return arrays: normalized,
sheared by ``shear_z`` along z, lifted ``hang`` along y; its own pins are
the vertices above the ``pin_quantile`` quantile of y.
"""

from __future__ import annotations

import numpy as np


def cloth_grid(rows: int, cols: int):
    verts, faces = [], []
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


def build(spec):
    rows = int(spec["rows"])
    V, F = cloth_grid(rows, rows)
    V = V / float(rows)
    V[:, 2] += float(spec["shear_z"]) * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    V[:, 1] += float(spec["hang"])
    pinned = V[:, 1] > np.quantile(V[:, 1], float(spec["pin_quantile"]))
    return V, F, None, pinned
