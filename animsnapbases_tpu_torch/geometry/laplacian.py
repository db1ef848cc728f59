"""Cotangent Laplace-Beltrami operator and per-vertex area matrix.

Copy of ``animsnapbases_tpu/geometry/laplacian.py`` (numpy/scipy): the
discrete operators of the heat-method geodesics behind the support maps
of local-support PCA and SPLOCS, as scipy sparse matrices for the host's
prefactorization, and their COO triplets.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def cotan_laplacian(verts: np.ndarray, tris: np.ndarray):
    """Build (L, VA): the symmetric cotan Laplacian (negative semi-definite,
    diagonal = -rowsum of off-diagonals) and the diagonal vertex-area matrix.

    Convention matches the reference: w_ij = 0.5 * (cot a + cot b) off-diagonal
    and vertex areas = sum of incident triangle areas / 3.
    """
    v = np.asarray(verts, dtype=float)
    f = np.asarray(tris, dtype=np.int64)
    n = v.shape[0]

    I, J, W = [], [], []
    for i1, i2, i3 in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
        vi1, vi2, vi3 = f[:, i1], f[:, i2], f[:, i3]
        u = v[vi2] - v[vi1]
        w = v[vi3] - v[vi1]
        cross = np.cross(u, w)
        cotan = (u * w).sum(axis=1) / np.linalg.norm(cross, axis=1)
        I.append(vi2); J.append(vi3); W.append(0.5 * cotan)
        I.append(vi3); J.append(vi2); W.append(0.5 * cotan)
    I = np.concatenate(I)
    J = np.concatenate(J)
    W = np.concatenate(W)
    L = sparse.csr_matrix((W, (I, J)), shape=(n, n))
    L = L - sparse.spdiags(L @ np.ones(n), 0, n, n)
    L = L.tocsr()

    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    vertex_area = np.zeros(n)
    for k in range(3):
        np.add.at(vertex_area, f[:, k], tri_area / 3.0)
    VA = sparse.spdiags(vertex_area, 0, n, n)
    return L, VA


def laplacian_coo(verts: np.ndarray, tris: np.ndarray):
    """COO triplets (rows, cols, vals) of the cotan Laplacian, for matrix-free
    device matvecs via segment-sum."""
    L, _ = cotan_laplacian(verts, tris)
    coo = L.tocoo()
    return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data
