"""Mesh topology queries the constraint groups need.

Counterpart of ``animsnapbases_tpu/geometry/mesh.py``: ``unique_edges``,
``tet_edges``, ``boundary_facets``, ``build_vertex_stars`` (with its
``StarEdge`` record) and its flattened form ``vertex_star_edges``, the
incidence queries of the geometric bases selection
(``elements_per_vertex``, ``vertex_star_vertices``, ``padded_incidence``),
the helpers of the snapshot import (``connected_components_labels``,
``largest_component_mask``, ``filter_reindex``, ``triangle_areas``) and
those of the analysis (``vertex_normals``, ``decimate_to_face_ratio``),
copied so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def unique_edges(faces: np.ndarray) -> np.ndarray:
    """Sorted unique undirected edges of a triangle mesh, (E, 2) with
    edge[i, 0] < edge[i, 1], ordered lexicographically."""
    faces = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def tet_edges(tets: np.ndarray) -> np.ndarray:
    """Sorted unique undirected edges of a tet mesh (6 per tet)."""
    tets = np.asarray(tets, dtype=np.int64)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    e = np.concatenate([tets[:, list(p)] for p in pairs])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def connected_components_labels(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """Vertex labels of connected components of the face graph."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    faces = np.asarray(faces, dtype=np.int64)
    ij = np.concatenate([faces[:, [0, 1]], faces[:, [0, 2]], faces[:, [1, 2]]])
    g = csr_matrix((np.ones(len(ij)), (ij[:, 0], ij[:, 1])),
                   shape=(n_verts, n_verts))
    _, labels = connected_components(g, directed=False)
    return labels


def largest_component_mask(n_verts: int, faces: np.ndarray) -> np.ndarray:
    labels = connected_components_labels(n_verts, faces)
    sizes = np.bincount(labels)
    return labels == sizes.argmax()


def filter_reindex(condition: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Reindex ``target`` indices after dropping the vertices where
    ``condition`` is False."""
    if condition.dtype != bool:
        raise ValueError("condition must be a boolean array")
    reindex = np.cumsum(condition) - 1
    return reindex[target]


def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v = np.asarray(verts)
    f = np.asarray(faces, dtype=np.int64)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return 0.5 * np.linalg.norm(n, axis=1)


def decimate_to_face_ratio(verts: np.ndarray, faces: np.ndarray,
                           face_ratio: float = 0.3):
    """Thin a triangle mesh to roughly ``face_ratio`` of its faces by
    uniform-grid vertex clustering (display-quality decimation for the
    viewers) -> (new_verts, new_faces).  Bisects the cluster cell size
    until the face count lands at or just under the target."""
    v = np.asarray(verts, dtype=float)
    f = np.asarray(faces, dtype=np.int64)
    target = max(4, int(face_ratio * len(f)))
    if target >= len(f):
        return v.copy(), f.copy()

    def cluster(cell):
        keys = np.floor((v - v.min(axis=0)) / cell).astype(np.int64)
        _, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        nv = int(inv.max()) + 1
        nV = np.zeros((nv, 3))
        cnt = np.zeros(nv)
        np.add.at(nV, inv, v)
        np.add.at(cnt, inv, 1.0)
        nV /= cnt[:, None]
        nf = inv[f]
        keep = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
                & (nf[:, 0] != nf[:, 2]))
        nf = nf[keep]
        if len(nf):
            _, first = np.unique(np.sort(nf, axis=1), axis=0,
                                 return_index=True)
            nf = nf[np.sort(first)]
        return nV, nf

    diag = float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))
    lo, hi = diag * 1e-4, diag          # fine (keeps all) .. coarse (1 cell)
    best = None
    for _ in range(24):
        mid = np.sqrt(lo * hi)
        nV, nf = cluster(mid)
        if len(nf) > target:
            lo = mid                     # too fine -> coarsen
        else:
            best = (nV, nf)
            hi = mid                     # at/under target -> try finer
        if hi / lo < 1.01:
            break
    if best is None:
        best = cluster(hi)
    return best


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (unit length; a vertex of no face
    gets a zero normal)."""
    v = np.asarray(verts)
    f = np.asarray(faces, dtype=np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    lens = np.linalg.norm(vn, axis=1)
    nz = lens > 1e-20
    vn[nz] /= lens[nz, None]
    return vn


def elements_per_vertex(vertex_indices, elements: np.ndarray) -> list[int]:
    """Indices of the elements (rows of tets, tris or edges) that contain
    any of the given vertices, in ascending order."""
    elements = np.asarray(elements)
    vset = np.asarray(list(vertex_indices))
    mask = np.isin(elements, vset).any(axis=1)
    return np.nonzero(mask)[0].tolist()


def vertex_star_vertices(vertex_index: int, faces: np.ndarray) -> list[int]:
    """The vertices of the faces incident to ``vertex_index`` (the vertex
    itself included), ascending."""
    faces = np.asarray(faces)
    mask = (faces == vertex_index).any(axis=1)
    return sorted(set(faces[mask].flatten().tolist()))


def padded_incidence(n_verts: int, elements: np.ndarray,
                     fill: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """Static-shape vertex -> element incidence: (table (N, Dmax), counts
    (N,)); table[v, :counts[v]] lists the elements containing v in
    ascending order, the remaining slots hold ``fill``."""
    elements = np.asarray(elements, dtype=np.int64)
    e_ids = np.repeat(np.arange(len(elements)), elements.shape[1])
    v_ids = elements.flatten()
    order = np.lexsort((e_ids, v_ids))
    v_sorted, e_sorted = v_ids[order], e_ids[order]
    counts = np.bincount(v_sorted, minlength=n_verts)
    dmax = int(counts.max()) if len(counts) else 0
    table = np.full((n_verts, dmax), fill, dtype=np.int64)
    # position within each vertex's run
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(v_sorted)) - starts[v_sorted]
    table[v_sorted, pos] = e_sorted
    return table, counts


def boundary_facets(tets: np.ndarray) -> np.ndarray:
    """Boundary triangles of a tet mesh: the faces that appear exactly
    once, each wound outward for a positively oriented tet (v0, v1, v2,
    v3): the face opposite each vertex, its normal pointing away from it."""
    tets = np.asarray(tets, dtype=np.int64)
    faces = np.concatenate([
        tets[:, [1, 2, 3]],
        tets[:, [0, 3, 2]],
        tets[:, [0, 1, 3]],
        tets[:, [0, 2, 1]],
    ])
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]


@dataclass
class StarEdge:
    """One 1-ring edge around a center vertex: neighbor ``v2``, the third
    vertex and triangle index of each adjacent triangle (t2 == -1 on
    boundary edges)."""
    v2: int
    v_other_t1: int
    t1: int
    v_other_t2: int = -1
    t2: int = -1


def build_vertex_stars(n_verts: int,
                       faces: np.ndarray) -> list[list[StarEdge]]:
    """1-ring stars for every vertex.  Each star lists the edges (center, v2)
    with both adjacent triangles where present, in the reference's construction
    order (triangles in order, vertices within a triangle in order)."""
    faces = np.asarray(faces, dtype=np.int64)
    stars: list[list[StarEdge]] = [[] for _ in range(n_verts)]
    for t in range(faces.shape[0]):
        tri = faces[t]
        for v in range(3):
            v_ind = tri[v]
            for ov in range(3):
                if v == ov:
                    continue
                nb = tri[ov]
                third = tri[3 - (v + ov)]
                for edge in stars[v_ind]:
                    if edge.v2 == nb:
                        edge.t2 = t
                        edge.v_other_t2 = third
                        break
                else:
                    stars[v_ind].append(StarEdge(v2=int(nb),
                                                 v_other_t1=int(third),
                                                 t1=t))
    return stars


def vertex_star_edges(n_verts: int, faces: np.ndarray) -> dict:
    """:func:`build_vertex_stars` flattened into int64 arrays over all star
    edges, grouped by center: ``center``, ``v2``, ``v_other_t1``, ``t1``,
    ``v_other_t2``, ``t2`` (S,) and ``star_offsets`` (N + 1,), the star of
    vertex v spanning [star_offsets[v], star_offsets[v + 1])."""
    stars = build_vertex_stars(n_verts, faces)
    counts = np.array([len(s) for s in stars])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    flat = [e for s in stars for e in s]
    return {
        "center": np.repeat(np.arange(n_verts), counts),
        "v2": np.array([e.v2 for e in flat], dtype=np.int64),
        "v_other_t1": np.array([e.v_other_t1 for e in flat], dtype=np.int64),
        "t1": np.array([e.t1 for e in flat], dtype=np.int64),
        "v_other_t2": np.array([e.v_other_t2 for e in flat], dtype=np.int64),
        "t2": np.array([e.t2 for e in flat], dtype=np.int64),
        "star_offsets": offsets,
    }
