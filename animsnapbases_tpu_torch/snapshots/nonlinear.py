"""Constraint-projection ("nonlinear") snapshots.

Counterpart of ``animsnapbases_tpu/snapshots/nonlinear.py`` (numpy, on the
host): the per-frame stacked projections p read into a (F, e*p, 3) tensor
from one frame-keyed ``.npz`` (as ``sim/solver.py`` records them) or from
per-frame ``.bin`` files; the train set is frames 0, inc, 2*inc, ..., the
test set offset by ``train_test_jump``; element masses from a ``.bin``
vector or accumulated from vertex masses per constrained element; the mass
weighting massL = sqrt(m), the standardization, and the export of the
snapshots mapped to position space as a components ``.h5``
(:meth:`NonlinearSnapshots.store_snapshots_animations`; h5py is imported
inside it).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from animsnapbases_tpu_torch.geometry.mass import (
    edge_element_masses,
    lumped_mass_normalized,
    tet_element_masses,
    tri_element_masses,
    vertex_masses_barycentric_tet,
    vertex_masses_voronoi,
)
from animsnapbases_tpu_torch.geometry.mesh import tet_edges, unique_edges
from animsnapbases_tpu_torch.io.binfmt import read_masses_bin
from animsnapbases_tpu_torch.io.meshes import load_medit_mesh, load_obj


def _read_bin_matrix(path: str) -> np.ndarray:
    """Column-major (ni, mi)-headed matrix used for per-frame p snapshots."""
    with open(path, "rb") as f:
        ni, mi = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(8 * ni * mi), dtype="<f8")
    return data.reshape((mi, ni)).T.copy()


class NonlinearSnapshots:
    def __init__(self, param=None):
        self.param = param
        self.snapshots_file = ""
        self.rest_shape = "first"
        self.dim = 3
        self.mass_file = ""
        self.frs = 0
        self.constraintsSize = 1  # p
        self.num_constained_elements = 0  # e
        self.mean = None
        self.pre_scale_factor = 1.0
        self.mass = None
        self.massL = None
        self.invMassL = None
        self.snapTensor = None
        self.test_snapTensor = None
        self.verts = None
        self.tris = None
        self.tets = None
        self.edges = None
        self.ele_type = ""
        self.frame_increment = 1
        self.train_test_jump = 1
        self.tet_mesh = ""
        self.tri_mesh = ""

    # ------------------------------------------------------------------
    def config(self) -> None:
        """Pull parameters from the attached BasesConfig."""
        p = self.param
        self.snapshots_file = p.constProj_input_snapshots_pattern
        self.rest_shape = p.constProj_rest_shape
        self.dim = p.constProj_dim
        self.mass_file = p.constProj_masses_file
        self.frs = p.constProj_numFrames
        self.constraintsSize = p.constProj_p_size
        self.ele_type = p.constProj_element_type
        self.frame_increment = p.constProj_frame_increment
        self.train_test_jump = p.constProj_train_test_jump
        self.tet_mesh = p.tet_mesh_file
        self.tri_mesh = p.tri_mesh_file

    # ------------------------------------------------------------------
    def snapshots_prepare(self) -> None:
        self.read()
        if self.param.constProj_massWeight:
            self.load_factorize_masses()
            if self.snapTensor.shape[1] != self.massL.shape[0]:
                raise ValueError("the element masses do not match the "
                                 "snapshots' rows")
            self.snapTensor *= self.massL[:, None]
        if self.param.constProj_standarize:
            self.standardize()

    # ------------------------------------------------------------------
    def read(self, file_type: str = ".npz") -> None:
        inc = self.frame_increment
        jump = self.train_test_jump
        if file_type == ".npz":
            data = np.load(self.snapshots_file, allow_pickle=True)
            train = [data[str(i)] for i in range(0, self.frs * inc, inc)]
            test = [data[str(j)] for j in range(jump, self.frs * inc, inc)]
        elif file_type == ".bin":
            train = [_read_bin_matrix(f"{self.snapshots_file}{i}.bin")
                     for i in range(0, self.frs * inc, inc)]
            test = [_read_bin_matrix(f"{self.snapshots_file}{i}.bin")
                    for i in range(jump, self.frs * inc, inc)]
        else:
            raise ValueError(f"unknown snapshots file type {file_type}")

        self.snapTensor = np.stack(train).astype(float)          # (F, ep, 3)
        self.test_snapTensor = np.stack(test).astype(float)
        self.num_constained_elements = (
            self.snapTensor.shape[1] // self.constraintsSize)

    # ------------------------------------------------------------------
    def load_factorize_masses(self) -> None:
        e, p = self.num_constained_elements, self.constraintsSize
        if self.mass_file and os.path.exists(self.mass_file):
            self.mass = read_masses_bin(self.mass_file)
        else:
            self.mass = self._compute_element_masses()
        if self.mass.shape[0] != e * p:
            raise ValueError(f"mass size {self.mass.shape[0]} != e*p = "
                             f"{e * p}")
        if not (self.mass >= 0).all():
            raise ValueError("element masses must be non-negative")
        massL = np.sqrt(self.mass)
        invMassL = np.where(massL != 0, 1.0 / np.where(massL == 0, 1.0, massL),
                            0.0)
        self.massL = massL
        self.invMassL = invMassL

    def _compute_element_masses(self) -> np.ndarray:
        p = self.constraintsSize
        e = self.num_constained_elements
        if p == 1:
            if self.param.volumetric_mesh:
                self.verts, self.tets, self.tris = load_medit_mesh(self.tet_mesh)
                vertex_masses = lumped_mass_normalized(self.verts, self.tets)
            else:
                self.verts, self.tris = load_obj(self.tri_mesh)
                vertex_masses = vertex_masses_voronoi(self.verts, self.tris)
            if self.param.constProj_snapshots_type == "verts_bending":
                verts = np.load(
                    self.param.constProj_input_snaps_constrained_elements
                )["indices"]
                return vertex_masses[verts]
            if self.param.constProj_snapshots_type == "edge_spring":
                if self.param.volumetric_mesh:
                    self.edges = tet_edges(self.tets)
                else:
                    self.edges = unique_edges(self.tris)
                return edge_element_masses(vertex_masses, self.edges, p)
            raise ValueError(
                f"unknown p=1 snapshots type {self.param.constProj_snapshots_type}")
        if p == 2:
            self.verts, self.tris = load_obj(self.tri_mesh)
            vertex_masses = vertex_masses_voronoi(self.verts, self.tris)
            return tri_element_masses(vertex_masses, self.tris, p)
        if p == 3:
            self.verts, self.tets, self.tris = load_medit_mesh(self.tet_mesh)
            vertex_masses = vertex_masses_barycentric_tet(self.verts, self.tets)
            return tet_element_masses(vertex_masses, self.tets, p)
        raise ValueError(f"unsupported constraint row size p={p} (e={e})")

    # ------------------------------------------------------------------
    def store_snapshots_animations(self, output_dir: str, file_name: str,
                                   St=None) -> str:
        """Map the stacked projections to position space through S^T and
        store them as a components ``.h5`` -> its path."""
        from animsnapbases_tpu_torch.io.h5anim import write_components_h5

        if St is None:
            St = np.load(self.param.constProj_weightedSt, allow_pickle=True)[
                self.param.costProj_St_key]
            if isinstance(St, np.ndarray) and St.dtype == object:
                St = St.item()
        if self.verts is None or self.tris is None:
            self.verts, self.tris = load_obj(self.param.tri_mesh_file)
        anim = np.stack([St @ self.snapTensor[f]
                         for f in range(self.snapTensor.shape[0])])
        path = os.path.join(output_dir, file_name)
        write_components_h5(path, self.verts, self.tris, anim)
        return path

    # ------------------------------------------------------------------
    def standardize(self) -> None:
        if self.rest_shape == "first":
            self.mean = self.snapTensor[0].copy()
        elif self.rest_shape == "average":
            self.mean = np.mean(self.snapTensor, axis=0)
        else:
            raise ValueError(f"unknown rest shape: {self.rest_shape}")
        self.snapTensor -= self.mean[np.newaxis]
        self.pre_scale_factor = 1.0 / np.std(self.snapTensor)
        self.snapTensor *= self.pre_scale_factor
