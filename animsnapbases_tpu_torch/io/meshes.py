"""Mesh readers and writers of the bases pipeline: OFF / COFF, ASCII PLY,
OBJ and MEDIT ``.mesh``.

Copy of ``animsnapbases_tpu/io/meshes.py`` (numpy only): the constraint
snapshots read a mesh to compute element masses, the geometric bases
selection reads its elements, the snapshot import reads an ``.off`` or
``.ply`` sequence; the pipeline writes the recorded model's mesh where a
bases config looks for it.
"""

from __future__ import annotations

import io

import numpy as np


def load_off(path: str, no_colors: bool = True):
    """Read an OFF/COFF file. Returns (verts, faces) when ``no_colors`` else
    (verts, colors, faces)."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and ln[0] != "#"]
    header = lines[0].strip()
    if header not in ("OFF", "COFF"):
        raise ValueError(f"OFF header missing in {path}")
    has_colors = header == "COFF"
    n_verts, n_faces, _ = map(int, lines[1].split())
    vertex_data = np.loadtxt(io.StringIO("".join(lines[2:2 + n_verts])),
                             dtype=float)
    vertex_data = np.atleast_2d(vertex_data)
    if n_faces > 0:
        faces = np.loadtxt(io.StringIO("".join(lines[2 + n_verts:])),
                           dtype=int)
        faces = np.atleast_2d(faces)[:, 1:]
    else:
        faces = None
    if has_colors:
        colors = vertex_data[:, 3:].astype(np.uint8)
        vertex_data = vertex_data[:, :3]
    else:
        colors = None
    if no_colors:
        return vertex_data, faces
    return vertex_data, colors, faces


def save_off(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    verts = np.asarray(verts)
    faces = np.asarray(faces, dtype=int)
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"{len(t)} " + " ".join(map(str, t)) + "\n")


def load_ply(path: str):
    """Minimal ASCII PLY reader (positions + triangle faces; polygons are
    fan-triangulated)."""
    with open(path, errors="replace") as f:
        if f.readline().strip() != "ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = f.readline().split()
        if fmt[1] != "ascii":
            raise ValueError("only ascii PLY is supported")
        n_verts = n_faces = 0
        current = None
        for line in f:
            tok = line.split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "element":
                current = tok[1]
                if current == "vertex":
                    n_verts = int(tok[2])
                elif current == "face":
                    n_faces = int(tok[2])
            elif tok[0] == "end_header":
                break
        verts = np.empty((n_verts, 3))
        for i in range(n_verts):
            vals = f.readline().split()
            verts[i] = [float(vals[0]), float(vals[1]), float(vals[2])]
        faces = []
        for _ in range(n_faces):
            vals = list(map(int, f.readline().split()))
            idx = vals[1:1 + vals[0]]
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, dtype=int)


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


def load_mesh_auto(path: str):
    """Dispatch on extension. Returns (verts, faces) for surface formats and
    (verts, tets, tris) for .mesh."""
    lower = path.lower()
    if lower.endswith(".off"):
        return load_off(path)
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".ply"):
        return load_ply(path)
    if lower.endswith(".mesh"):
        return load_medit_mesh(path)
    raise ValueError(f"unknown mesh format: {path}")
