"""Mesh readers of the bases pipeline: OBJ and MEDIT ``.mesh``.

Copy of ``load_obj``, ``load_medit_mesh``, ``save_obj`` and
``save_medit_mesh`` of ``animsnapbases_tpu/io/meshes.py`` (numpy only):
the constraint snapshots read a mesh to compute element masses, and the
geometric bases selection reads its elements; the pipeline writes the
recorded model's mesh where a bases config looks for it.
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


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(faces, dtype=int):
            f.write("f " + " ".join(str(i + 1) for i in t) + "\n")


def save_medit_mesh(path: str, verts: np.ndarray,
                    tets: np.ndarray | None = None,
                    tris: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 1\nDimension 3\n")
        f.write(f"Vertices\n{len(verts)}\n")
        for v in np.asarray(verts):
            f.write(f"{v[0]} {v[1]} {v[2]} 0\n")
        if tris is not None and len(tris):
            f.write(f"Triangles\n{len(tris)}\n")
            for t in np.asarray(tris, dtype=int):
                f.write(f"{t[0] + 1} {t[1] + 1} {t[2] + 1} 0\n")
        if tets is not None and len(tets):
            f.write(f"Tetrahedra\n{len(tets)}\n")
            for t in np.asarray(tets, dtype=int):
                f.write(f"{t[0] + 1} {t[1] + 1} {t[2] + 1} {t[3] + 1} 0\n")
        f.write("End\n")
