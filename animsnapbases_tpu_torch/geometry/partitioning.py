"""Heat/graph distances, farthest-point sampling, and Voronoi-style
partitioning on surface and tetrahedral meshes.

Copy of ``animsnapbases_tpu/geometry/partitioning.py`` (numpy/scipy, on
the host): surface distances use the prefactored heat method
(:class:`GeodesicDistance`); tet-mesh and fallback paths use
edge-length-weighted graph Dijkstra via scipy.  FPS and label helpers work
with any distance oracle.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from animsnapbases_tpu_torch.geometry.geodesics import GeodesicDistance
from animsnapbases_tpu_torch.geometry.mesh import tet_edges, unique_edges


def _edge_graph(V: np.ndarray, edges: np.ndarray) -> sp.csr_matrix:
    n = V.shape[0]
    w = np.linalg.norm(V[edges[:, 0]] - V[edges[:, 1]], axis=1)
    g = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])), shape=(n, n))
    return (g + g.T).tocsr()


def graph_distance(V: np.ndarray, edges: np.ndarray, sources) -> np.ndarray:
    """Multi-source edge-length-weighted shortest-path distances."""
    g = _edge_graph(V, edges)
    d = dijkstra(g, directed=False, indices=np.atleast_1d(sources))
    d = d.min(axis=0)
    return d - d.min()


def heat_distance_surface(V, F, sources, oracle: GeodesicDistance | None = None):
    """Heat-method distances on a triangle mesh (prefactored oracle reused
    when provided); equivalent of ``utils/utils.py:515-...``."""
    if oracle is None:
        oracle = GeodesicDistance(V, F)
    return oracle(np.atleast_1d(sources))


def heat_distance_tet(V, T, sources) -> np.ndarray:
    """Distances on a tet mesh: edge-graph Dijkstra (the reference's tet path
    degrades to the same when igl is absent)."""
    return graph_distance(V, tet_edges(T), sources)


def fps_with_distance(n_vertices: int, dist_from_sources_fn, k: int,
                      start: int | None = None):
    """Generic farthest-point sampling over a distance oracle
    (ref ``utils/utils.py:701-725``).  Returns (seeds (k,), min_dist (n,))."""
    if start is None:
        start = 0
    seeds = [int(start)]
    d = np.nan_to_num(np.asarray(dist_from_sources_fn(seeds), dtype=float),
                      nan=0.0, posinf=0.0)
    for _ in range(1, k):
        i = int(np.argmax(d))
        seeds.append(i)
        d_new = np.nan_to_num(
            np.asarray(dist_from_sources_fn([i]), dtype=float),
            nan=0.0, posinf=0.0)
        d = np.minimum(d, d_new)
    return np.array(seeds, dtype=int), d


def surface_seeds_heat(V, F, k, start=None):
    """FPS on a surface with heat distances; warm-up hop to a far vertex
    first (ref ``utils/utils.py:730-742``)."""
    oracle = GeodesicDistance(V, F)
    if start is None:
        start = 0
    d0 = oracle(start)
    start = int(np.argmax(d0))
    return fps_with_distance(
        V.shape[0], lambda S: oracle(np.atleast_1d(S)), k, start=start)


def tet_seeds_heat(V, T, k, start=None):
    return fps_with_distance(
        V.shape[0], lambda S: heat_distance_tet(V, T, S), k,
        start=start if start is not None else 0)


def geodesic_labels_surface_from_seeds(V, F, seeds):
    """Per-vertex nearest-seed labels via one distance field per seed.
    Returns (labels (n,), D (n, k))."""
    oracle = GeodesicDistance(V, F)
    seeds = np.asarray(seeds, int).ravel()
    D = np.column_stack([oracle(int(s)) for s in seeds])
    D -= D.min(axis=0, keepdims=True)
    return np.argmin(D, axis=1), D


def geodesic_labels_tet_from_seeds(V, T, seeds):
    seeds = np.asarray(seeds, int).ravel()
    D = np.column_stack([heat_distance_tet(V, T, [int(s)]) for s in seeds])
    D -= D.min(axis=0, keepdims=True)
    return np.argmin(D, axis=1), D


def tet_labels_from_vertex_labels(T, vertex_labels, D=None, rule="mode"):
    """Aggregate per-vertex labels to per-tet labels
    (ref ``utils/utils.py:779-804``)."""
    T = np.asarray(T)
    if rule == "mode":
        lab = np.asarray(vertex_labels)[T]               # (m, 4)
        out = np.empty(len(T), dtype=int)
        for i, row in enumerate(lab):
            vals, counts = np.unique(row, return_counts=True)
            out[i] = vals[np.argmax(counts)]
        return out
    if D is None:
        raise ValueError("D (n, k) distances required for rule="
                         f"'{rule}'")
    tet_vals = D[T]                                       # (m, 4, k)
    if rule == "mean":
        scores = tet_vals.mean(axis=1)
    elif rule == "min":
        scores = tet_vals.min(axis=1)
    else:
        raise ValueError("rule must be 'mode', 'mean', or 'min'")
    return np.argmin(scores, axis=1)
