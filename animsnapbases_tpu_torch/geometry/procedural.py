"""Procedural test meshes.

Counterpart of ``animsnapbases_tpu/geometry/procedural.py``: only
``cloth_model``, with the same vertex order and winding, so a scene built
here and one built by the JAX package are the same scene.
"""

from __future__ import annotations

import numpy as np


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
