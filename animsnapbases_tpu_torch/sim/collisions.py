"""Collision handling on the host.

Counterpart of ``animsnapbases_tpu/sim/collisions.py``, in numpy/scipy as
there: the floor clamp that ``step()`` uses for the
``positions_corrections`` bookkeeping, and the self-collision resolvers
that ``enable_self_collision = True`` runs after every step (the
reference's ``Constraint_projections.py:1311-1419``): a vertex pushed out
of its nearest triangles (a triangle-centroid KD-tree, k = 5), and close
triangle pairs pushed apart (a centroid ball query, AABB rejection, the
closest points of the pair).  Both are O(n) Python loops, so they suit
small scenes; ``enable_self_collision = "device"`` runs the masked
O(n*k) pass of ``sim/collisions_device.py`` on the state's device.
"""

from __future__ import annotations

import numpy as np


def resolve_floor_collision(positions: np.ndarray, floor_height: float):
    """Clamp y to the floor; returns (new_positions, corrections) where
    corrections = -(new - old) per vertex."""
    new = positions.copy()
    below = new[:, 1] < floor_height
    new[below, 1] = floor_height
    corrections = -(new - positions)
    return new, corrections


def tangential_friction_response(velocities: np.ndarray,
                                 corrections: np.ndarray,
                                 friction_coeff: float = 0.2,
                                 repulsion_coeff: float = 0.0) -> np.ndarray:
    """Post-collision velocity response: remove the normal component along
    the collision correction, damp the tangential part by the friction
    coefficient, add repulsion along the correction."""
    v = velocities.copy()
    norms = np.linalg.norm(corrections, axis=1)
    active = norms > 1e-12
    if not active.any():
        return v
    n = corrections[active] / norms[active, None]
    vn = (v[active] * n).sum(axis=1, keepdims=True) * n
    vt = (v[active] - vn) * (1.0 - friction_coeff)
    v[active] = vt + repulsion_coeff * corrections[active]
    return v


def _point_triangle_closest(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, by Ericson's Voronoi
    regions; returns (distance, point)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1, d2 = ab @ ap, ac @ ap
    if d1 <= 0 and d2 <= 0:
        return np.linalg.norm(ap), a
    bp = p - b
    d3, d4 = ab @ bp, ac @ bp
    if d3 >= 0 and d4 <= d3:
        return np.linalg.norm(bp), b
    cp = p - c
    d5, d6 = ab @ cp, ac @ cp
    if d6 >= 0 and d5 <= d6:
        return np.linalg.norm(cp), c
    vc = d1 * d4 - d3 * d2
    if vc <= 0 and d1 >= 0 and d3 <= 0:
        v = d1 / (d1 - d3)
        proj = a + v * ab
        return np.linalg.norm(p - proj), proj
    vb = d5 * d2 - d1 * d6
    if vb <= 0 and d2 >= 0 and d6 <= 0:
        w = d2 / (d2 - d6)
        proj = a + w * ac
        return np.linalg.norm(p - proj), proj
    va = d3 * d6 - d5 * d4
    if va <= 0 and (d4 - d3) >= 0 and (d5 - d6) >= 0:
        w = (d4 - d3) / ((d4 - d3) + (d5 - d6))
        proj = b + w * (c - b)
        return np.linalg.norm(p - proj), proj
    denom = 1.0 / (va + vb + vc)
    v = vb * denom
    w = vc * denom
    proj = a + ab * v + ac * w
    return np.linalg.norm(p - proj), proj


def resolve_self_collision_fast(vertices: np.ndarray, faces: np.ndarray,
                                min_dist: float = 0.001,
                                stiffness: float = 1.0) -> np.ndarray:
    """Vertex-vs-nearest-triangles pushout using a centroid KD-tree (k=5);
    a vertex's own triangles are skipped."""
    from scipy.spatial import cKDTree

    centroids = vertices[faces].mean(axis=1)
    tree = cKDTree(centroids)
    k = min(5, len(faces))
    _, nearest = tree.query(vertices, k=k)
    nearest = np.atleast_2d(nearest)
    new_vertices = vertices.copy()
    for vi, p in enumerate(vertices):
        for fi in np.atleast_1d(nearest[vi]):
            f = faces[fi]
            if vi in f:
                continue
            d, closest = _point_triangle_closest(p, *vertices[f])
            if 1e-8 < d < min_dist:
                direction = (p - closest) / d
                new_vertices[vi] += stiffness * (min_dist - d) * direction
    return new_vertices


def resolve_triangle_self_collisions(vertices: np.ndarray, faces: np.ndarray,
                                     min_dist: float = 0.001,
                                     stiffness: float = 0.5) -> np.ndarray:
    """Triangle-pair pushout: centroid ball query at 3 min_dist, AABB
    rejection, pairs sharing a vertex skipped, closest-point separation."""
    from scipy.spatial import cKDTree

    tris = vertices[faces]
    centroids = tris.mean(axis=1)
    aabb_min = tris.min(axis=1)
    aabb_max = tris.max(axis=1)
    tree = cKDTree(centroids)
    updated = vertices.copy()

    for i in range(len(faces)):
        for j in tree.query_ball_point(centroids[i], r=3 * min_dist):
            if j <= i:
                continue
            if len(set(faces[i]) & set(faces[j])) > 0:
                continue
            if not (np.all(aabb_max[i] + min_dist >= aabb_min[j])
                    and np.all(aabb_max[j] + min_dist >= aabb_min[i])):
                continue
            tri_i = updated[faces[i]]
            tri_j = updated[faces[j]]
            too_close = any(
                _point_triangle_closest(p, *tri_j)[0] < min_dist
                for p in tri_i) or any(
                _point_triangle_closest(p, *tri_i)[0] < min_dist
                for p in tri_j)
            if not too_close:
                continue
            for a, vi in enumerate(faces[i]):
                d, closest = _point_triangle_closest(tri_i[a], *tri_j)
                if 1e-8 < d < min_dist:
                    updated[vi] += stiffness * (min_dist - d) * (
                        tri_i[a] - closest) / d
            for b, vj in enumerate(faces[j]):
                d, closest = _point_triangle_closest(tri_j[b], *tri_i)
                if 1e-8 < d < min_dist:
                    updated[vj] += stiffness * (min_dist - d) * (
                        tri_j[b] - closest) / d
    return updated


def resolve_self_collisions(vertices: np.ndarray,
                            faces: np.ndarray) -> np.ndarray:
    """Both host resolvers in the order the solvers run them
    (``enable_self_collision = True``): the vertex pass, then the
    triangle-pair pass."""
    out = resolve_self_collision_fast(vertices, faces)
    return resolve_triangle_self_collisions(out, faces)
