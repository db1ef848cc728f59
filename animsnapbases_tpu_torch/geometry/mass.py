"""Mass lumping: per-vertex Voronoi / barycentric masses and per-element
(constraint-row) masses.

Copy of ``animsnapbases_tpu/geometry/mass.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package: the constraint
snapshots (``snapshots/nonlinear.py``) weight their rows with it.
"""

from __future__ import annotations

import numpy as np


def vertex_masses_voronoi(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Mixed-Voronoi (Meyer et al.) per-vertex cell areas of a triangle mesh.

    Matches libigl's MASSMATRIX_TYPE_VORONOI: non-obtuse triangles contribute
    true Voronoi areas via cotangents; obtuse triangles contribute area/2 at
    the obtuse corner and area/4 at the other two.
    """
    v = np.asarray(verts, dtype=float)
    f = np.asarray(faces, dtype=np.int64)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    # squared edge lengths opposite each corner
    l0 = ((p1 - p2) ** 2).sum(1)   # opposite corner 0
    l1 = ((p2 - p0) ** 2).sum(1)
    l2 = ((p0 - p1) ** 2).sum(1)
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
    safe_area = np.maximum(area, 1e-300)
    # cotangent at corner i = (l_j + l_k - l_i) / (8 * area) * 2 ... derive:
    # cot(theta_i) = (b^2 + c^2 - a^2) / (4 * area) with a opposite theta_i
    cot0 = (l1 + l2 - l0) / (4.0 * safe_area)
    cot1 = (l2 + l0 - l1) / (4.0 * safe_area)
    cot2 = (l0 + l1 - l2) / (4.0 * safe_area)
    # Voronoi area at corner i: (l_j * cot_j + l_k * cot_k) / 8
    a0 = (l1 * cot1 + l2 * cot2) / 8.0
    a1 = (l2 * cot2 + l0 * cot0) / 8.0
    a2 = (l0 * cot0 + l1 * cot1) / 8.0
    corner_areas = np.stack([a0, a1, a2], axis=1)

    obtuse0 = cot0 < 0
    obtuse1 = cot1 < 0
    obtuse2 = cot2 < 0
    any_obtuse = obtuse0 | obtuse1 | obtuse2
    if any_obtuse.any():
        fallback = np.stack([
            np.where(obtuse0, area / 2.0, area / 4.0),
            np.where(obtuse1, area / 2.0, area / 4.0),
            np.where(obtuse2, area / 2.0, area / 4.0),
        ], axis=1)
        corner_areas = np.where(any_obtuse[:, None], fallback, corner_areas)

    masses = np.zeros(v.shape[0])
    for k in range(3):
        np.add.at(masses, f[:, k], corner_areas[:, k])
    return masses


def vertex_masses_barycentric_tet(verts: np.ndarray,
                                  tets: np.ndarray) -> np.ndarray:
    """Barycentric lumped masses of a tet mesh: each tet contributes |vol|/4
    to each of its vertices."""
    v = np.asarray(verts, dtype=float)
    t = np.asarray(tets, dtype=np.int64)
    d = v[t]
    vol = np.abs(np.einsum(
        "ij,ij->i",
        np.cross(d[:, 1] - d[:, 0], d[:, 2] - d[:, 0]),
        d[:, 3] - d[:, 0])) / 6.0
    masses = np.zeros(v.shape[0])
    for k in range(4):
        np.add.at(masses, t[:, k], vol / 4.0)
    return masses


def lumped_mass_normalized(verts: np.ndarray, tets: np.ndarray,
                           density: float = 1.0) -> np.ndarray:
    """Barycentric tet lumping normalized to unit total mass
    (ref ``utils/support.py:41-59``)."""
    m = density * vertex_masses_barycentric_tet(verts, tets)
    total = m.sum()
    return m / total if total > 0 else m


# ---------------------------------------------------------------------------
# per-element (constraint-row) masses: each element's mass is the sum of its
# vertex masses, replicated over the constraint's p rows
# ---------------------------------------------------------------------------

def _element_masses(vertex_masses: np.ndarray, elements: np.ndarray,
                    p: int) -> np.ndarray:
    w = np.asarray(vertex_masses)[np.asarray(elements, dtype=np.int64)].sum(axis=1)
    return np.repeat(w, p)


def tet_element_masses(vertex_masses, tets, p: int = 3) -> np.ndarray:
    """(e*p,) masses for tet constraints (ref utils/support.py:12-23)."""
    assert p == 3
    return _element_masses(vertex_masses, tets, p)


def tri_element_masses(vertex_masses, tris, p: int = 2) -> np.ndarray:
    """(e*p,) masses for tri-strain constraints (ref utils/support.py:62-76)."""
    assert p == 2
    return _element_masses(vertex_masses, tris, p)


def edge_element_masses(vertex_masses, edges, p: int = 1) -> np.ndarray:
    """(e*p,) masses for edge-spring constraints (ref utils/support.py:26-38)."""
    return _element_masses(vertex_masses, edges, p)
