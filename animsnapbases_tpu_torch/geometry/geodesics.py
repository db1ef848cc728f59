"""Heat-method geodesic distances (Crane, Weischedel, Wardetzky 2013).

Copy of ``animsnapbases_tpu/geometry/geodesics.py`` (numpy/scipy): the
support maps of local-support PCA and SPLOCS.  Two sparse LU
factorizations per mesh (heat diffusion and Poisson) on the host with
scipy's ``splu``, then one back-substitution pair per query; a query's
sources may be an index, an index list or a boolean mask.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse.linalg import splu

from animsnapbases_tpu_torch.geometry.laplacian import cotan_laplacian


def _veclen(x):
    return np.sqrt((x ** 2).sum(axis=-1))


def _normalized(x):
    return x / _veclen(x)[..., None]


class GeodesicDistance:
    """Callable: ``GeodesicDistance(verts, tris)(idx) -> phi (N,)``.

    ``idx`` may be an int, an index list, or a boolean mask — distances are to
    the heat source set.
    """

    def __init__(self, verts: np.ndarray, tris: np.ndarray, m: float = 10.0):
        v = np.asarray(verts, dtype=float)
        f = np.asarray(tris, dtype=np.int64)
        self._verts = v
        self._tris = f

        e01 = v[f[:, 1]] - v[f[:, 0]]
        e12 = v[f[:, 2]] - v[f[:, 1]]
        e20 = v[f[:, 0]] - v[f[:, 2]]
        self._tri_area = 0.5 * _veclen(np.cross(e01, e12))
        unit_normal = _normalized(np.cross(_normalized(e01), _normalized(e12)))
        self._n_x_e01 = np.cross(unit_normal, e01)
        self._n_x_e12 = np.cross(unit_normal, e12)
        self._n_x_e20 = np.cross(unit_normal, e20)

        h = np.mean([_veclen(e01).mean(), _veclen(e12).mean(),
                     _veclen(e20).mean()])
        t = m * h ** 2
        Lc, A = cotan_laplacian(v, f)
        self._heat_solve = splu((A - t * Lc).tocsc()).solve
        self._poisson_solve = splu(Lc.tocsc()).solve

        # divergence cotangents, precomputed per corner rotation
        self._div_cots = []
        for i1, i2, i3 in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
            vi1, vi2, vi3 = f[:, i1], f[:, i2], f[:, i3]
            e1 = v[vi2] - v[vi1]
            e2 = v[vi3] - v[vi1]
            e_opp = v[vi3] - v[vi2]
            cot1 = 1.0 / np.tan(np.arccos(np.clip(
                (_normalized(-e2) * _normalized(-e_opp)).sum(axis=1), -1, 1)))
            cot2 = 1.0 / np.tan(np.arccos(np.clip(
                (_normalized(-e1) * _normalized(e_opp)).sum(axis=1), -1, 1)))
            self._div_cots.append((vi1, e1, e2, cot1, cot2))

    def __call__(self, idx) -> np.ndarray:
        n = len(self._verts)
        u0 = np.zeros(n)
        u0[idx] = 1.0
        # 1. heat diffusion
        u = self._heat_solve(u0).ravel()
        # 2. normalized negative gradient
        f = self._tris
        grad_u = (1.0 / (2 * self._tri_area))[:, None] * (
            self._n_x_e01 * u[f[:, 2]][:, None]
            + self._n_x_e12 * u[f[:, 0]][:, None]
            + self._n_x_e20 * u[f[:, 1]][:, None]
        )
        X = -grad_u / _veclen(grad_u)[:, None]
        # 3. integrated divergence + Poisson solve
        div = np.zeros(n)
        for vi1, e1, e2, cot1, cot2 in self._div_cots:
            div += np.bincount(
                vi1,
                0.5 * (cot1 * (e1 * X).sum(axis=1) + cot2 * (e2 * X).sum(axis=1)),
                minlength=n)
        phi = self._poisson_solve(div).ravel()
        return phi - phi.min()
