"""Mesh readers of the bases pipeline: OBJ and MEDIT ``.mesh``.

Copy of ``load_obj`` and ``load_medit_mesh`` of
``animsnapbases_tpu/io/meshes.py`` (numpy only), which the constraint
snapshots read to compute element masses.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Read vertex positions and triangle faces from an OBJ file.
    Polygon faces are fan-triangulated; v/vt/vn indices use the position."""
    verts = []
    faces = []
    # errors="replace": OBJ headers in the wild carry non-UTF-8 comment
    # bytes (the reference's armadillo.obj has a latin-1 (c) sign); the
    # v/f records themselves are ASCII
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) for tok in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=float), np.asarray(faces, dtype=int)


def load_medit_mesh(path: str):
    """Read a MEDIT .mesh file. Returns (verts, tets, tris); tets/tris may be
    empty arrays. Mirrors the schema the reference consumes
    (``utils/utils.py:325-382``). Indices converted to 0-based."""
    verts = np.empty((0, 3))
    tets = np.empty((0, 4), dtype=int)
    tris = np.empty((0, 3), dtype=int)
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    n = len(tokens)

    def read_block(count, width):
        nonlocal i
        # each record: `width` coordinates/indices followed by a ref tag
        flat = np.array(tokens[i:i + count * (width + 1)], dtype=float)
        i += count * (width + 1)
        return flat.reshape(count, width + 1)[:, :width]

    while i < n:
        kw = tokens[i].lower()
        i += 1
        if kw == "vertices":
            cnt = int(tokens[i]); i += 1
            verts = read_block(cnt, 3)
        elif kw == "tetrahedra":
            cnt = int(tokens[i]); i += 1
            tets = read_block(cnt, 4).astype(int) - 1
        elif kw == "triangles":
            cnt = int(tokens[i]); i += 1
            tris = read_block(cnt, 3).astype(int) - 1
        elif kw == "edges":
            cnt = int(tokens[i]); i += 1
            read_block(cnt, 2)
        elif kw in ("corners", "requiredvertices", "ridges"):
            cnt = int(tokens[i]); i += 1
            i += cnt
        elif kw == "end":
            break
        # skip unknown scalar tokens (MeshVersionFormatted value, Dimension value)
    return verts, tets, tris
