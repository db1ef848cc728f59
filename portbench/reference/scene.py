"""The scene of a configuration as plain arrays, and its constraint groups.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3, of:

* ``animsnapbases_tpu_torch/geometry/procedural.py`` ``cloth_model`` and
  ``bar_model``, ``geometry/mesh.py`` ``unique_edges``, ``tet_edges`` and
  ``boundary_facets``: the same vertex, face, tet and edge order, so that
  the element indices of the bases this package makes name the same
  elements in the program's model;
* ``bases/pipeline.py`` ``bench_model`` (the bench cloth) and
  ``chip_smoke.py`` ``bar_scene``, ``rescale`` and
  ``sim/model.py`` ``compute_cloth_corner_indices`` (the bar and its pinned
  sides), rewritten to return arrays instead of a model;
* ``sim/groups.py`` ``build_tris_strain``, ``build_edge_spring`` and
  ``_tet_group`` (tets_deformation_gradient), reduced to what the reference
  reads: each group's rest data, its S^T as a scipy matrix and its
  per-dimension block of the global matrix.

Nothing here imports the program or the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import scipy.sparse

FLOOR_HEIGHT = 0.0
PIN_MASS = 1e10


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


def unique_edges(faces: np.ndarray) -> np.ndarray:
    faces = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.unique(np.sort(e, axis=1), axis=0)


def tet_edges(tets: np.ndarray) -> np.ndarray:
    tets = np.asarray(tets, dtype=np.int64)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    e = np.concatenate([tets[:, list(p)] for p in pairs])
    return np.unique(np.sort(e, axis=1), axis=0)


@dataclass
class Group:
    """One constraint group: ``p`` rows an element, ``num`` elements, the
    rest data its projection reads, ``ST`` (N, num * p) and ``block`` the
    group's (N, N) share of each dimension's global matrix."""
    name: str
    p: int
    num: int
    data: dict
    ST: scipy.sparse.csr_matrix
    block: scipy.sparse.csr_matrix


@dataclass
class Scene:
    positions: np.ndarray          # (N, 3) initial positions
    faces: np.ndarray              # (F, 3)
    tets: np.ndarray | None        # (T, 4) or None
    mass: np.ndarray               # (N,) nominal masses
    pinned: np.ndarray             # (N,) bool
    floor: bool
    groups: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    @property
    def masses(self) -> np.ndarray:
        """The masses the solve sees: pinned vertices at PIN_MASS."""
        m = self.mass.copy()
        m[self.pinned] = PIN_MASS
        return m


def _coo(rows, cols, vals, shape):
    return scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=shape).tocsr()


def tris_strain(faces, wi, positions, sigma_min, sigma_max) -> Group:
    faces = np.asarray(faces, dtype=np.int64)
    e, n = len(faces), len(positions)
    p1, p2, p3 = (positions[faces[:, k]] for k in range(3))
    e1, e2 = p2 - p1, p3 - p1
    b0 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    b1 = e2 - (e2 * b0).sum(axis=1, keepdims=True) * b0
    b1 = b1 / np.linalg.norm(b1, axis=1, keepdims=True)
    P = np.stack([b0, b1], axis=2)                              # (e, 3, 2)
    rest2d = np.einsum("eij,eik->ejk", P, np.stack([e1, e2], axis=2))
    DmInv = np.linalg.inv(rest2d)
    scale = wi * np.abs(0.5 * np.linalg.det(rest2d))
    B = np.empty((e, 3, 2))
    B[:, 1], B[:, 2] = DmInv[:, 0], DmInv[:, 1]
    B[:, 0] = -(DmInv[:, 0] + DmInv[:, 1])
    st = [(faces[:, j], np.arange(e) * 2 + c, B[:, j, c] * scale)
          for j in range(3) for c in range(2)]
    K = np.einsum("eac,ebc->eab", B, B) * scale[:, None, None]
    blk = [(faces[:, a], faces[:, b], K[:, a, b])
           for a in range(3) for b in range(3)]
    return Group("tris_strain", 2, e,
                 {"faces": faces, "P": P, "DmInv": DmInv,
                  "sigma_min": float(sigma_min), "sigma_max": float(sigma_max)},
                 _coo(*zip(*st), (n, 2 * e)), _coo(*zip(*blk), (n, n)))


def edge_spring(edges, wi, positions) -> Group:
    edges = np.asarray(edges, dtype=np.int64)
    e, n = len(edges), len(positions)
    rest = np.linalg.norm(positions[edges[:, 0]] - positions[edges[:, 1]],
                          axis=1)
    v0, v1 = edges[:, 0], edges[:, 1]
    w = np.full(e, 0.5 * wi)
    ST = _coo((v0, v1), (np.arange(e), np.arange(e)),
              (np.full(e, -wi), np.full(e, wi)), (n, e))
    blk = _coo((v0, v1, v0, v1), (v0, v1, v1, v0), (w, w, -w, -w), (n, n))
    return Group("edge_spring", 1, e, {"edges": edges, "rest_length": rest},
                 ST, blk)


def tets_deformation_gradient(tets, wi, positions) -> Group:
    tets = np.asarray(tets, dtype=np.int64)
    e, n = len(tets), len(positions)
    p = positions[tets]
    Dm = np.stack([p[:, 0] - p[:, 3], p[:, 1] - p[:, 3], p[:, 2] - p[:, 3]],
                  axis=2)
    DmInv = np.linalg.inv(Dm)
    scale = wi * np.abs(np.linalg.det(Dm) / 6.0)
    G = np.concatenate([DmInv, -DmInv.sum(axis=1, keepdims=True)], axis=1)
    st = [(tets[:, j], np.arange(e) * 3 + c, G[:, j, c] * scale)
          for j in range(4) for c in range(3)]
    K = np.einsum("eic,ejc->eij", G, G) * scale[:, None, None]
    blk = [(tets[:, a], tets[:, b], K[:, a, b])
           for a in range(4) for b in range(4)]
    return Group("tets_deformation_gradient", 3, e,
                 {"elements": tets, "DmInv": DmInv},
                 _coo(*zip(*st), (n, 3 * e)), _coo(*zip(*blk), (n, n)))


def _cloth(spec):
    rows = int(spec["rows"])
    V, F = cloth_grid(rows, rows)
    V = V / float(rows)
    V[:, 2] += float(spec["shear_z"]) * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    V[:, 1] += float(spec["hang"])
    pinned = V[:, 1] > np.quantile(V[:, 1], float(spec["pin_quantile"]))
    return V, F, None, pinned


def _bar(spec):
    V, T, F = bar_grid(*spec["size"])
    V = V - V.min(axis=0)
    extent = (V.max(axis=0) - V.min(axis=0)).max()
    V = V / extent - 0.5
    V[:, 1] += float(spec["lift"])
    x = V[:, 0]
    thresh = float(spec["pin_threshold"]) * (x.max() - x.min())
    surface = np.zeros(len(V), dtype=bool)
    surface[np.unique(F)] = True
    pinned = surface & ((x <= x.min() + thresh) | (x >= x.max() - thresh))
    return V, F, T, pinned


SCENES = {"cloth": _cloth, "bar": _bar}


def build_scene(cfg: dict) -> Scene:
    """The scene of configuration ``cfg`` (its ``scene`` and ``groups``)."""
    spec = cfg["scene"]
    V, F, T, pinned = SCENES[spec["kind"]](spec)
    scene = Scene(positions=V, faces=F, tets=T,
                  mass=np.full(len(V), float(spec["mass"])), pinned=pinned,
                  floor=bool(spec["floor"]))
    for name, g in cfg["groups"].items():
        if name == "tris_strain":
            scene.groups[name] = tris_strain(F, g["wi"], V, g["sigma_min"],
                                             g["sigma_max"])
        elif name == "edge_spring":
            E = tet_edges(T) if T is not None else unique_edges(F)
            scene.groups[name] = edge_spring(E, g["wi"], V)
        elif name == "tets_deformation_gradient":
            scene.groups[name] = tets_deformation_gradient(T, g["wi"], V)
        else:
            raise ValueError(f"no reference for constraint kind {name}")
    return scene


def global_block(scene: Scene, dt: float) -> scipy.sparse.csc_matrix:
    """One dimension's (N, N) global matrix: M / dt^2 + the groups'
    blocks (every group couples equal dimensions only, alike in each)."""
    A = scipy.sparse.diags(scene.masses / (dt * dt))
    for g in scene.groups.values():
        A = A + g.block
    return A.tocsc()


def gravity(scene: Scene) -> np.ndarray:
    """-9.81 x the nominal mass along y on every vertex."""
    f = np.zeros_like(scene.positions)
    f[:, 1] = -9.81 * scene.mass
    return f
