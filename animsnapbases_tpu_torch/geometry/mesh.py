"""Mesh topology queries the constraint groups need.

Counterpart of ``animsnapbases_tpu/geometry/mesh.py``: only
``unique_edges``, ``tet_edges``, ``boundary_facets``, ``build_vertex_stars``
(with its ``StarEdge`` record), the incidence queries of the geometric
bases selection (``elements_per_vertex``, ``vertex_star_vertices``) and
the helpers of the snapshot import (``connected_components_labels``,
``largest_component_mask``, ``filter_reindex``, ``triangle_areas``),
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
