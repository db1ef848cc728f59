"""Volumetric utilities: generalized winding numbers and surface
tetrahedralization.

Copy of ``animsnapbases_tpu/geometry/volume.py`` (numpy/scipy, on the
host): the winding number is the exact solid-angle sum (Jacobson et al.
2013), vectorized in point blocks; tetrahedralization takes the Delaunay
tets of the surface vertices whose barycenters have a winding number
above a threshold.  With ``steiner=True`` a Delaunay-refinement pass
inserts circumcenters of low-quality interior tets (the tetgen-style
quality mechanism), for thin or highly non-convex surfaces where the
vertex-only Delaunay produces slivers."""

from __future__ import annotations

import numpy as np


def winding_number(V: np.ndarray, F: np.ndarray,
                   points: np.ndarray,
                   max_pairs: int = 20_000_000) -> np.ndarray:
    """Generalized winding number of ``points`` (m, 3) w.r.t. the closed
    triangle mesh (V, F).  ~1 inside, ~0 outside.

    Evaluated in point blocks of <= ``max_pairs`` point-triangle pairs:
    the solid-angle sum materializes (m, t, 3) temporaries, which at
    production scale (e.g. tetrahedralizing the 14k-vert bunny: ~90k
    Delaunay barycenters x 28.5k faces) would need TBs whole."""
    V = np.asarray(V, dtype=float)
    F = np.asarray(F, dtype=np.int64)
    P = np.atleast_2d(np.asarray(points, dtype=float))
    m, t = len(P), len(F)
    if m * t > max_pairs:
        rows = max(1, max_pairs // max(t, 1))
        return np.concatenate([
            winding_number(V, F, P[i:i + rows], max_pairs=max_pairs)
            for i in range(0, m, rows)])

    # solid angle of each triangle as seen from each point
    a = V[F[:, 0]][None, :, :] - P[:, None, :]     # (m, t, 3)
    b = V[F[:, 1]][None, :, :] - P[:, None, :]
    c = V[F[:, 2]][None, :, :] - P[:, None, :]
    la = np.linalg.norm(a, axis=2)
    lb = np.linalg.norm(b, axis=2)
    lc = np.linalg.norm(c, axis=2)
    num = np.einsum("mtj,mtj->mt", a, np.cross(b, c))
    den = (la * lb * lc + np.einsum("mtj,mtj->mt", a, b) * lc
           + np.einsum("mtj,mtj->mt", b, c) * la
           + np.einsum("mtj,mtj->mt", c, a) * lb)
    omega = 2.0 * np.arctan2(num, den)
    return omega.sum(axis=1) / (4.0 * np.pi)


def orient_faces_consistently(F: np.ndarray) -> np.ndarray:
    """Propagate a consistent orientation over a manifold triangle mesh by
    BFS over shared edges (two adjacent faces are consistent iff they
    traverse their shared edge in opposite directions).  The global sign
    stays ambiguous — pair with |winding number| for inside tests."""
    F = np.asarray(F, dtype=np.int64).copy()
    from collections import defaultdict, deque

    edge_faces = defaultdict(list)
    for t, tri in enumerate(F):
        for k in range(3):
            e = (tri[k], tri[(k + 1) % 3])
            edge_faces[tuple(sorted(e))].append(t)

    visited = np.zeros(len(F), dtype=bool)
    for start in range(len(F)):
        if visited[start]:
            continue
        visited[start] = True
        queue = deque([start])
        while queue:
            t = queue.popleft()
            tri = F[t]
            directed = {(tri[k], tri[(k + 1) % 3]) for k in range(3)}
            for k in range(3):
                key = tuple(sorted((tri[k], tri[(k + 1) % 3])))
                for nb in edge_faces[key]:
                    if nb == t or visited[nb]:
                        continue
                    nb_tri = F[nb]
                    nb_directed = {(nb_tri[j], nb_tri[(j + 1) % 3])
                                   for j in range(3)}
                    # same direction on the shared edge => inconsistent
                    if directed & nb_directed:
                        F[nb] = nb_tri[::-1]
                    visited[nb] = True
                    queue.append(nb)
    return F


def tet_quality(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Per-tet shape quality in (0, 1]: ``6*sqrt(2)*vol / l_rms^3`` — 1
    for the regular tetrahedron, -> 0 for slivers (volume-degenerate
    elements with non-degenerate edges)."""
    P = np.asarray(V, dtype=float)[np.asarray(T, dtype=np.int64)]
    e = np.stack([P[:, 1] - P[:, 0], P[:, 2] - P[:, 0], P[:, 3] - P[:, 0],
                  P[:, 2] - P[:, 1], P[:, 3] - P[:, 1], P[:, 3] - P[:, 2]],
                 axis=1)                              # (m, 6, 3)
    vol = np.abs(np.einsum(
        "mj,mj->m", np.cross(e[:, 0], e[:, 1]), e[:, 2])) / 6.0
    l_rms = np.sqrt((e ** 2).sum(axis=2).mean(axis=1))
    return 6.0 * np.sqrt(2.0) * vol / np.maximum(l_rms, 1e-300) ** 3


def _circumcenters(V: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Circumcenters of tets (m, 3) (rows of 2(p_i - p_0) x = |p_i|^2 -
    |p_0|^2)."""
    P = np.asarray(V, dtype=float)[np.asarray(T, dtype=np.int64)]
    A = 2.0 * (P[:, 1:] - P[:, :1])                   # (m, 3, 3)
    b = (P[:, 1:] ** 2).sum(axis=2) - (P[:, :1] ** 2).sum(axis=2)
    # guard degenerate tets: fall back to the barycenter
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-12
    centers = P.mean(axis=1)
    if ok.any():
        centers[ok] = np.linalg.solve(A[ok], b[ok][..., None])[..., 0]
    return centers


def tetrahedralize(V: np.ndarray, F: np.ndarray,
                   inside_threshold: float = 0.5,
                   steiner: bool = False, min_quality: float = 0.15,
                   max_rounds: int = 4, max_points: int | None = None):
    """Tetrahedralize the volume bounded by surface (V, F):
    Delaunay of the vertices, keeping tets whose barycenter has winding
    number > threshold.  Returns (TV, IT, F_boundary) with the same
    reversed-winding convention as the reference wrapper.

    ``steiner=True`` adds tetgen-style quality refinement: up to
    ``max_rounds`` passes insert the circumcenters of interior tets with
    :func:`tet_quality` below ``min_quality`` (only circumcenters that
    land strictly inside the surface) and re-run the filtered Delaunay.
    ``max_points`` caps the number of inserted Steiner vertices (default
    ``len(V)``).  TV then contains the surface vertices first, Steiner
    vertices after — consumers indexing surface vertices by position are
    unaffected."""
    from scipy.spatial import Delaunay

    from animsnapbases_tpu_torch.geometry.mesh import boundary_facets

    V = np.asarray(V, dtype=float)
    F = orient_faces_consistently(F)
    if max_points is None:
        max_points = len(V)

    scale = (V.max(axis=0) - V.min(axis=0)).max()

    def build(P):
        TT = Delaunay(P).simplices.astype(np.int64)[:, ::-1]
        # drop zero-volume Delaunay artifacts (cospherical/coplanar point
        # configurations, e.g. regular grids, triangulate flat sims)
        Pt = P[TT]
        vol = np.abs(np.einsum(
            "mj,mj->m", np.cross(Pt[:, 1] - Pt[:, 0], Pt[:, 2] - Pt[:, 0]),
            Pt[:, 3] - Pt[:, 0])) / 6.0
        TT = TT[vol > 1e-10 * scale ** 3]
        bc = P[TT].mean(axis=1)
        w = winding_number(V, F, bc)
        return TT[np.abs(w) > inside_threshold]

    TV = V
    IT = build(TV)
    if steiner:
        budget = max_points
        for _ in range(max_rounds):
            q = tet_quality(TV, IT)
            bad = IT[q < min_quality]
            if len(bad) == 0 or budget <= 0:
                break
            cand = _circumcenters(TV, bad)
            # strictly interior circumcenters only (boundary slivers whose
            # circumcenter escapes the surface cannot be refined this way)
            w = np.abs(winding_number(V, F, cand))
            cand = cand[w > 0.9]
            # dedup near-coincident candidates (shared circumspheres)
            if len(cand):
                scale = (V.max(axis=0) - V.min(axis=0)).max()
                key = np.round(cand / (1e-6 * scale)).astype(np.int64)
                _, keep = np.unique(key, axis=0, return_index=True)
                cand = cand[np.sort(keep)][:budget]
            if len(cand) == 0:
                break
            budget -= len(cand)
            TV = np.concatenate([TV, cand])
            IT = build(TV)

    faces = boundary_facets(IT)
    return TV, IT, faces[:, ::-1]
