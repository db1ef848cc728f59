"""Position snapshots: the aligned train/test animations, mass-weighted and
standardized, with the geodesic-distance oracle of the support maps.

Counterpart of ``animsnapbases_tpu/snapshots/position.py`` (numpy/scipy on
the host; ``bases/pca.py`` moves the snapshot tensor to the device):
  - snapTensor (F, N, 3) = massL * verts  (if mass weighting)
  - masses from a little-endian .bin vector if present, else Voronoi lumping
    on the first frame, normalized  M <- M / sum(M) * 2
  - massL = sqrt(diag(M)), invMassL = 1/massL
  - mean = first or average frame of the (weighted) tensor
  - standardize: subtract mean, scale by 1/std
  - geodesics are prepared on the *unweighted* rest shape
The constructor reads the .h5 files; :meth:`PositionSnapshots.from_arrays`
takes the animation itself, so that a recording in memory needs no
``h5py``.
"""

from __future__ import annotations

import os

import numpy as np

from animsnapbases_tpu_torch.geometry.geodesics import GeodesicDistance
from animsnapbases_tpu_torch.geometry.mass import (
    vertex_masses_barycentric_tet,
    vertex_masses_voronoi,
)
from animsnapbases_tpu_torch.io.binfmt import read_masses_bin
from animsnapbases_tpu_torch.io.h5anim import read_animation_h5
from animsnapbases_tpu_torch.io.meshes import load_medit_mesh


class PositionSnapshots:
    def __init__(self, train_h5: str, test_h5: str | None,
                 rest_shape: str = "first", masses_file: str = "",
                 tet_mesh_file: str = "", standardize: bool = True,
                 mass_weight: bool = True,
                 build_geodesics: bool = True):
        """Read ``train_h5`` (and ``test_h5`` where it exists), then
        :meth:`prepare`."""
        self.rest_shape = rest_shape
        self.masses_file = masses_file
        self.tet_mesh_file = tet_mesh_file
        verts, tris, _ = read_animation_h5(train_h5)
        test = None
        if test_h5 is not None and os.path.exists(test_h5):
            test = read_animation_h5(test_h5)[:2]
        self.prepare(verts, tris, test, standardize, mass_weight,
                     build_geodesics)

    @classmethod
    def from_arrays(cls, verts: np.ndarray, tris: np.ndarray,
                    test=None, rest_shape: str = "first",
                    masses_file: str = "", tet_mesh_file: str = "",
                    standardize: bool = True, mass_weight: bool = True,
                    build_geodesics: bool = True) -> "PositionSnapshots":
        """The snapshots of an aligned animation ``verts`` (F, N, 3) on
        ``tris`` (``test``: the test animation's (verts, tris), or None),
        as the constructor prepares those of the .h5 files."""
        snaps = cls.__new__(cls)
        snaps.rest_shape = rest_shape
        snaps.masses_file = masses_file
        snaps.tet_mesh_file = tet_mesh_file
        snaps.prepare(verts, tris, test, standardize, mass_weight,
                      build_geodesics)
        return snaps

    def prepare(self, verts, tris, test=None, standardize: bool = True,
                mass_weight: bool = True, build_geodesics: bool = True):
        """Mass weighting, the rest shape, the geodesic oracle and the
        standardization of ``verts`` (float64 on the host)."""
        self.verts = np.asarray(verts, dtype=float)
        self.tris = np.asarray(tris)
        self.test_verts, self.test_tris = (
            (None, None) if test is None
            else (np.asarray(test[0], dtype=float), np.asarray(test[1])))
        self.frs, self.nVerts, _ = self.verts.shape

        self.mean = None
        self.pre_scale_factor = 1.0
        self.mass = None
        self.massL = None
        self.invMassL = None
        self.compute_geodesic_distance = None

        self.snapTensor = self.verts.copy()

        if mass_weight:
            self._read_factorize_masses()
            if self.snapTensor.shape[1] != self.massL.shape[0]:
                raise ValueError("masses and snapshots differ in vertices")
            self.snapTensor *= self.massL[:, None]

        if self.rest_shape == "first":
            self.mean = self.snapTensor[0].copy()
            rest_unweighted = self.verts[0]
        elif self.rest_shape == "average":
            self.mean = np.mean(self.snapTensor, axis=0)
            rest_unweighted = np.mean(self.verts, axis=0)
        else:
            raise ValueError(f"unknown rest shape: {self.rest_shape}")

        if build_geodesics:
            self.compute_geodesic_distance = GeodesicDistance(
                rest_unweighted, self.tris)

        if standardize:
            self._standardize()

    # ------------------------------------------------------------------
    def _read_factorize_masses(self, mass_on_tet_mesh: bool = False) -> None:
        if self.masses_file and os.path.exists(self.masses_file):
            masses = read_masses_bin(self.masses_file)
            if masses.shape[0] != self.nVerts:
                raise ValueError(f"{self.masses_file} holds "
                                 f"{masses.shape[0]} masses, not "
                                 f"{self.nVerts}")
        else:
            if mass_on_tet_mesh:
                _, tets, _ = load_medit_mesh(self.tet_mesh_file)
                masses = vertex_masses_barycentric_tet(self.verts[0], tets)
            else:
                masses = vertex_masses_voronoi(self.verts[0], self.tris)
            masses = masses / masses.sum() * 2.0
        self.mass = masses.copy()
        self.massL = np.sqrt(masses)
        self.invMassL = 1.0 / self.massL

    def _standardize(self) -> None:
        self.snapTensor -= self.mean[np.newaxis]
        self.pre_scale_factor = 1.0 / np.std(self.snapTensor)
        self.snapTensor *= self.pre_scale_factor
