"""Constraint-projection components: POD and block-PCA bases, and DEIM,
block-DEIM and geometric interpolation-point selection.

Counterpart of ``animsnapbases_tpu/bases/constraints.py``
``ConstraintComponents``, on the port's device in float64:

* ``pod_vectorized``: one snapshot POD of the flattened (e*p*3, F)
  snapshot matrix;
* ``pod``: a snapshot POD of each (p, d) slice's (e, F) matrix;
* ``pca_blocks``: the greedy block deflation (the element of largest
  residual energy, then one rank-1 deflation per row of its block), a loop
  of K steps on the device;
* ``pca_blocks_with_St``: the greedy deflation whose element set grows by
  the elements adjacent to the vertex of largest position-space residual
  (through the differential operator St), until ``||R|| < bases_R_tol`` or
  the requested component count (the cap the JAX package puts on the
  reference's unbounded loop), with its warning;
* the post-processing (standardization undone, orthogonalization, mass
  weighting);
* the selections, on the JAX package's backends: row DEIM and block DEIM on
  the host float64 ``lstsq`` loop below ``DEIM_DEVICE_MIN_K`` modes and on
  the device loops of ``ops/deim_scan.py`` at and above (or as the config's
  ``deim_device`` says), with the guards for a rank-deficient basis (the
  host loop truncates at a zero residual; duplicate device picks re-run on
  the host; each warns); the geometric selection
  (``geom_block_form_utilizing_differential_operator``) on the host, in
  both ``error_in_pos_space`` modes and with the ``verts_bending``
  constrained-vertex map;
* the reconstruction and its errors (``geom_constructed``) and the ``.npz``
  the reduced solver reads.

Known quirk kept from the JAX package: on ``pod_vectorized`` components
with p > 1 the geometric selection walks the modes in groups of p and
truncates, with a "zero residual" warning, at the first empty group.

The sharded bases compute: ``device_mesh_shards`` > 1 builds a
("model",) mesh of that many ranks of the caller's process group
(``parallel/ensemble.py::mesh_from_shards``, kept as ``pod_mesh``; with
fewer ranks it warns and stays on one device, as the JAX package does), and
with a mesh the POD's Gram product is an ``all_reduce``
(``snapshot_pod_sharded``) and both DEIM forms run the device scan with
their rows split over the mesh.  Every rank of the mesh runs the whole
pipeline; the picks are those of one device.
"""

from __future__ import annotations

import csv
import os
import warnings

import numpy as np
import torch

from animsnapbases_tpu_torch.bases.greedy import signed_nonneg_weight
from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device
from animsnapbases_tpu_torch.geometry.mesh import (
    elements_per_vertex,
    tet_edges,
    unique_edges,
    vertex_star_vertices,
)
from animsnapbases_tpu_torch.io.binfmt import (
    write_components,
    write_points_vector,
)
from animsnapbases_tpu_torch.io.meshes import load_medit_mesh, load_obj
from animsnapbases_tpu_torch.ops.deim_scan import (
    deim_blocks_host_result,
    deim_rows_host_result,
)
from animsnapbases_tpu_torch.ops.podlinalg import (
    snapshot_pod,
    snapshot_pod_sharded,
)
from animsnapbases_tpu_torch.parallel.ensemble import mesh_from_shards
from animsnapbases_tpu_torch.ops.svd3 import top_mode_rows
from animsnapbases_tpu_torch.snapshots.nonlinear import NonlinearSnapshots
from animsnapbases_tpu_torch.utils.checks import (
    is_linear_independent,
    sparsity_fractions,
    utmu_orthogonality_error,
)
from animsnapbases_tpu_torch.utils.timing import log_time

# smallest mode budget at which the device DEIM scan is the default (the
# JAX package's choice: below it the host float64 loop, whose lstsq
# rounding pinned artifact builds rely on)
DEIM_DEVICE_MIN_K = 64


def _deim_device_auto(param, mesh, K: int) -> bool:
    """The config's ``deim_device`` if set, else the scan with a mesh or at
    K >= DEIM_DEVICE_MIN_K."""
    flag = getattr(param, "deim_device", None)
    if flag is not None:
        return bool(flag)
    return mesh is not None or K >= DEIM_DEVICE_MIN_K


# ---------------------------------------------------------------------------
# the greedy deflation on the device
# ---------------------------------------------------------------------------

def _select_block(R: torch.Tensor, p: int, e: int) -> int:
    """The element of largest residual block energy.  R (F, e*p, d)."""
    row_energy = (R ** 2).sum(dim=(0, 2))
    return int(torch.argmax(row_energy.reshape(e, p).sum(dim=1)))


def _deflate_row(R: torch.Tensor, row: int, use_signed: bool):
    """The dominant mode of one (3, F) row trajectory and the rank-1
    deflation of the whole tensor -> (sigma0, wk, ck, R')."""
    sigma0, wk = top_mode_rows(R[:, row, :].T)
    if use_signed:
        wk = signed_nonneg_weight(wk)
    ck = torch.einsum("f,fnd->nd", wk, R) / (wk @ wk)
    return sigma0, wk, ck, R - wk[:, None, None] * ck[None]


def _extract_blocks(R: torch.Tensor, p: int, e: int, K: int):
    """``pca_blocks``' K greedy steps on the device -> (C (K, p, ep, d),
    W (K, p, F), sigmas (K, p), rows (K, p), elements (K,), residual norms
    (K,)), the picks and norms as numpy."""
    C, W, sig, rows, idxs, res = [], [], [], [], [], []
    for _ in range(K):
        idx = _select_block(R, p, e)
        cks, wks, sigmas = [], [], []
        for i in range(p):
            sigma0, wk, ck, R = _deflate_row(R, idx * p + i, False)
            cks.append(ck)
            wks.append(wk)
            sigmas.append(sigma0)
        C.append(torch.stack(cks))
        W.append(torch.stack(wks))
        sig.append(torch.stack(sigmas))
        rows.append([idx * p + i for i in range(p)])
        idxs.append(idx)
        res.append(torch.linalg.vector_norm(R))
    return (torch.stack(C), torch.stack(W), torch.stack(sig).cpu().numpy(),
            np.array(rows, dtype=np.int64), np.array(idxs, dtype=np.int64),
            torch.stack(res).cpu().numpy())


# ---------------------------------------------------------------------------


class ConstraintComponents:
    def __init__(self, param, snapshots: NonlinearSnapshots | None = None,
                 device=None):
        self.param = param
        self.device = resolve_device(device)
        if snapshots is None:
            snapshots = NonlinearSnapshots(param)
        self.nonlinearSnapshots = snapshots

        self.basesType = ""
        self.numComp = 0
        self.support = param.constProj_support
        self.storeSingVal = False
        self.comps: np.ndarray | None = None   # (Kp, ep, 3)
        self.singVals: np.ndarray | None = None
        self.weigs: np.ndarray | None = None
        self.largeDeforPoints = None
        self.largeDeforBlocks = None
        self.measures_at_largeDeforVerts = None
        self._comps_device = None
        self.St = None

        self.geom_interpol_verts: list[int] = []
        self.geom_alpha = None
        self.geom_Pt = None
        self.geom_alpha_ranges = None

        self.fileNameBases = "p_nl_"
        self.fileName_geom_points = "p_nl_interpol_points_"
        self.file_name_sing = "_constrprojBases_pcaExtraction_singValues"
        self.pod_mesh = mesh_from_shards(
            getattr(param, "device_mesh_shards", 0), self.device)

    # ------------------------------------------------------------------
    def config(self, fileNameBases="p_nl_",
               fileName_geom_points="p_nl_interpol_points_",
               file_name_sing="_constrprojBases_pcaExtraction_singValues"):
        p = self.param
        self.basesType = p.constProj_bases_interpolation_type
        self.support = p.constProj_support
        self.storeSingVal = p.constProj_store_sing_val
        self.fileNameBases = fileNameBases
        self.fileName_geom_points = fileName_geom_points
        self.file_name_sing = file_name_sing
        st = np.load(p.constProj_weightedSt,
                     allow_pickle=True)[p.costProj_St_key]
        if isinstance(st, np.ndarray) and st.dtype == object:
            st = st.item()
        self.St = st  # scipy sparse (N, e*p)

    # ------------------------------------------------------------------
    @log_time
    def compute_components_store_singvalues(self):
        btype = self.param.constProj_basis_type
        dispatch = {
            "pod": self.compute_pod,
            "pod_vectorized": self.compute_pod_vectorized,
            "pca_blocks": self.compute_pca_blocks,
            "pca_blocks_with_St": self.compute_pca_blocks_with_st,
        }
        if btype not in dispatch:
            raise ValueError(f"Unknown basis type: {btype}")
        if not self.storeSingVal:
            dispatch[btype](None)
            return
        p = self.nonlinearSnapshots.constraintsSize
        if btype in ("pca_blocks", "pca_blocks_with_St"):
            header = (["component", "idx", "residual_matrix_norm"]
                      + [f"singVal{i}" for i in range(p)])
        else:
            header = ["component", "singVal"]
        file_name = os.path.join(
            self.param.constProj_output_directory,
            self.param.name + "_" + self.param.constProj_name
            + self.file_name_sing)
        with open(file_name + ".csv", "w", encoding="UTF8") as f:
            writer = csv.writer(f)
            writer.writerow(header)
            dispatch[btype](writer)

    @log_time
    def compute_pod_vectorized(self, writer=None):
        """One snapshot POD of the flattened (e*p*3, F) matrix on the
        device; the kept modes stay there for a device DEIM."""
        R = self.nonlinearSnapshots.snapTensor
        F = R.shape[0]
        e = self.nonlinearSnapshots.num_constained_elements
        p = self.nonlinearSnapshots.constraintsSize
        if self.pod_mesh is not None:
            U, S, _ = snapshot_pod_sharded(R.reshape(F, -1).T, self.pod_mesh,
                                           device=self.device)
        else:
            U, S, _ = snapshot_pod(R.reshape(F, -1).T, device=self.device)
        S = S.cpu().numpy()
        self.singVals = S
        if writer is not None:
            for i, s in enumerate(S):
                writer.writerow([i + 1, s])
        k = self.param.deim_desired_num_components
        # snapshot_pod zero-fills the columns past the numerical rank;
        # keeping them would hand DEIM exactly-zero basis vectors
        rank = int((S > 1e-12 * (S[0] + 1e-30)).sum())
        if 0 < k and min(k, F) > rank:
            warnings.warn(f"pod_vectorized: requested {k} components but "
                          f"the snapshot rank is {rank}; truncating")
        k = min(k if k > 0 else F, rank)
        self._comps_device = U[:, :k].T.reshape(k, e * p, -1)
        self.comps = np.ascontiguousarray(
            self._comps_device.cpu().numpy()).astype(np.float64)
        self.numComp = k

    @log_time
    def compute_pod(self, writer=None):
        """A snapshot POD of each (p, d) slice's (e, F) matrix; component
        k holds every slice's k-th mode (its sign is each slice's own)."""
        R = self.nonlinearSnapshots.snapTensor
        F = R.shape[0]
        e = self.nonlinearSnapshots.num_constained_elements
        p = self.nonlinearSnapshots.constraintsSize
        d = R.shape[-1]
        X = R.reshape(F, e, p, d)
        C = np.empty((F, e, p, d))
        for i in range(p):
            for l in range(d):
                U, _, _ = snapshot_pod(X[:, :, i, l].T, device=self.device)
                C[:, :, i, l] = U.T.cpu().numpy()
        C = C.reshape(F, e * p, d)
        k = self.param.deim_desired_num_components
        self.comps = C[:k] if k < C.shape[0] else C
        self._comps_device = None
        self.numComp = self.comps.shape[0]

    @log_time
    def compute_pca_blocks(self, writer=None):
        """The greedy block deflation on the device (K steps)."""
        snaps = self.nonlinearSnapshots
        p = snaps.constraintsSize
        e = snaps.num_constained_elements
        K = self.param.deim_desired_num_components
        R = torch.as_tensor(snaps.snapTensor, dtype=PIPELINE_DTYPE,
                            device=self.device)
        C, W, sig, rows, idxs, res = _extract_blocks(R, p, e, K)
        self.comps = C.reshape(K * p, -1, C.shape[-1]).cpu().numpy()
        self._comps_device = None
        self.weigs = W.reshape(K * p, -1).T.cpu().numpy()
        self.largeDeforPoints = idxs
        self.largeDeforBlocks = rows.reshape(-1)
        self.numComp = K
        measures = []
        for k in range(K):
            row = [k, int(idxs[k]), float(res[k])] + [float(x)
                                                      for x in sig[k]]
            measures.append(row)
            if writer is not None:
                writer.writerow(row)
        self.measures_at_largeDeforVerts = np.array(measures)

    @log_time
    def compute_pca_blocks_with_st(self, writer=None):
        """The greedy deflation driven by the position-space residual
        through St: each step deflates every element adjacent to the vertex
        of largest residual energy, until ||R|| < bases_R_tol or the
        requested component count (default min(F, e)), warning when the
        tolerance was not reached.  The deflations run on the device, the
        vertex search on the host."""
        snaps = self.nonlinearSnapshots
        p = snaps.constraintsSize
        tol = self.param.bases_R_tol
        St = self.St.tocsr()
        if self.support == "local":
            raise ValueError("Local support maps are not available for "
                             "nonlinear-term components")
        R = torch.as_tensor(snaps.snapTensor, dtype=PIPELINE_DTYPE,
                            device=self.device)
        C, W, measures = [], [], []
        S_v_idx: list[int] = []
        bases_count = 0
        K = self.param.deim_desired_num_components
        if K is None or K <= 0:
            K = min(R.shape[0], snaps.num_constained_elements)
        max_components = K

        def pos_space_vertex(R):
            # (F, ep, d) -> (ep, F*d); St @ . -> (N, F*d); argmax row energy
            Rm = R.transpose(0, 1).reshape(R.shape[1], -1).cpu().numpy()
            return int(np.argmax(((St @ Rm) ** 2).sum(axis=1)))

        res = float(torch.linalg.vector_norm(R))
        while res > tol and bases_count < max_components:
            v = pos_space_vertex(R)
            elems = self._adjacent_elements(v)
            S_v_idx.append(v)
            for idx in elems:
                sigma = []
                for i in range(p):
                    sigma0, wk, ck, R = _deflate_row(R, idx * p + i, False)
                    sigma.append(float(sigma0))
                    C.append(ck.cpu().numpy())
                    W.append(wk.cpu().numpy())
                bases_count += 1
                res = float(torch.linalg.vector_norm(R))
                row = [bases_count, idx, res] + sigma
                measures.append(row)
                if writer is not None:
                    writer.writerow(row)
                if res < tol or bases_count >= max_components:
                    break
        if res > tol:
            warnings.warn(
                f"pca_blocks_with_St stopped at {bases_count} components "
                f"(cap {max_components}) with ||R||={res:.3e} > "
                f"tol={tol:.3e}")
        self.comps = np.array(C)
        self._comps_device = None
        self.weigs = np.array(W).T
        self.numComp = self.comps.shape[0] // p
        self.largeDeforPoints = np.array(S_v_idx)
        self.measures_at_largeDeforVerts = measures

    # ------------------------------------------------------------------
    def _ensure_elements(self):
        """The snapshots' mesh elements, read from the config's mesh files
        where they are not loaded yet."""
        snaps = self.nonlinearSnapshots
        if snaps.ele_type == "_tets" and snaps.tets is None:
            snaps.verts, snaps.tets, snaps.tris = load_medit_mesh(
                self.param.tet_mesh_file)
        elif snaps.ele_type in ("_tris", "_verts") and snaps.tris is None:
            snaps.verts, snaps.tris = load_obj(self.param.tri_mesh_file)
        elif snaps.ele_type == "_edges" and snaps.edges is None:
            if self.param.volumetric_mesh:
                if snaps.tets is None:
                    snaps.verts, snaps.tets, snaps.tris = load_medit_mesh(
                        self.param.tet_mesh_file)
                snaps.edges = tet_edges(snaps.tets)
            else:
                if snaps.tris is None:
                    snaps.verts, snaps.tris = load_obj(
                        self.param.tri_mesh_file)
                snaps.edges = unique_edges(snaps.tris)

    def _adjacent_elements(self, v: int) -> list[int]:
        """The constrained elements adjacent to vertex v, per element
        type."""
        self._ensure_elements()
        snaps = self.nonlinearSnapshots
        if snaps.ele_type == "_tets":
            return elements_per_vertex([v], snaps.tets)
        if snaps.ele_type == "_tris":
            return elements_per_vertex([v], snaps.tris)
        if snaps.ele_type == "_edges":
            return elements_per_vertex([v], snaps.edges)
        if snaps.ele_type == "_verts":
            return vertex_star_vertices(v, snaps.tris)
        raise ValueError(f"unknown element type {snaps.ele_type}")

    # ------------------------------------------------------------------
    @log_time
    def post_process_components(self):
        snaps = self.nonlinearSnapshots
        if (self.param.constProj_standarize or self.param.constProj_orthogonal
                or self.param.constProj_massWeight):
            # comps change below: the device copy is stale
            self._comps_device = None
        if self.param.constProj_standarize:
            self.comps = self.comps / snaps.pre_scale_factor
            self.comps = self.comps + snaps.mean[np.newaxis]
            # the snapshot tensor is un-standardized too, for later error
            # measures
            snaps.snapTensor = snaps.snapTensor / snaps.pre_scale_factor
            snaps.snapTensor = snaps.snapTensor + snaps.mean[np.newaxis]

        if self.param.constProj_orthogonal:
            for l in range(self.comps.shape[2]):
                q, _ = np.linalg.qr(self.comps[:, :, l].T)
                self.comps[:, :, l] = q.T

        if self.param.constProj_massWeight:
            if (self.comps.shape[1] != snaps.invMassL.shape[0]
                    or snaps.snapTensor.shape[1] != snaps.invMassL.shape[0]):
                raise ValueError("the element masses do not match the "
                                 "components' rows")
            self.comps = self.comps * snaps.invMassL[:, None]
            snaps.snapTensor = snaps.snapTensor * snaps.invMassL[:, None]

    def is_utmu_orthogonal(self, atol: float = 1e-8) -> bool:
        err = utmu_orthogonality_error(self.comps,
                                       self.nonlinearSnapshots.mass)
        return err < atol

    def sparsity(self):
        return sparsity_fractions(self.comps)

    def linear_independent(self) -> bool:
        p = self.nonlinearSnapshots.constraintsSize
        return is_linear_independent(self.comps, self.numComp * p)

    # ------------------------------------------------------------------
    # interpolation point selection
    # ------------------------------------------------------------------

    def _device_comps(self):
        """``self.comps`` on the device, uploaded once per change."""
        comps_dev = self._comps_device
        if comps_dev is None or tuple(comps_dev.shape) != self.comps.shape:
            self._comps_device = torch.as_tensor(self.comps,
                                                 device=self.device)
        return self._comps_device

    def deim(self, device: bool | None = None):
        """Row-wise DEIM on the (ep, K, d) bases.  ``device=True`` runs the
        scan on the device (``ops/deim_scan.py``), False the host float64
        loop, None as :func:`_deim_device_auto` says.  Duplicate device
        picks (a rank-exhausted basis) warn and re-run on the host, whose
        zero-residual check truncates with a warning."""
        p = self.nonlinearSnapshots.constraintsSize
        d = self.nonlinearSnapshots.dim
        K = self.numComp
        if device is None:
            device = _deim_device_auto(self.param, self.pod_mesh, K)
        if device:
            Pt, alphas, ranges = deim_rows_host_result(
                self._device_comps().transpose(0, 1), p, K,
                device=self.device, mesh=self.pod_mesh)
            if len(np.unique(Pt)) < len(Pt):
                warnings.warn("device DEIM produced duplicate selections "
                              "(rank-deficient basis); falling back to the "
                              "host loop")
            else:
                self.geom_Pt = Pt
                self.geom_alpha = alphas
                self.geom_alpha_ranges = ranges
                self.geom_interpol_verts = np.array(
                    self.geom_interpol_verts)
                return
        bases = self.comps.swapaxes(0, 1)     # (ep, K, d)

        Pt: list[int] = []
        e_points: list[int] = []
        e_range: list[int] = []
        # the selected modes per dimension, transposed and preallocated:
        # VT[i, :k] is the (k, ep) view of V[:, :k, i].T
        VT = np.empty((d, K, bases.shape[0]))
        sel = np.empty(K, dtype=np.int64)
        for k in range(K):
            vk = bases[:, k, :]               # (ep, d)
            if k == 0:
                r = vk
            else:
                c = np.empty(vk.shape)
                for i in range(d):
                    sol = np.linalg.lstsq(VT[i, :k][:, sel[:k]].T,
                                          vk[sel[:k], i], rcond=None)[0]
                    c[:, i] = sol @ VT[i, :k]
                r = c - vk
                if np.allclose(r, 0):
                    # the basis is exhausted on the selected rows: keep the
                    # k selections made so far
                    warnings.warn(f"DEIM: zero residual at mode {k}; "
                                  f"truncating to {k} points")
                    self.comps = self.comps[:k]
                    self._comps_device = None
                    self.numComp = k
                    break
            idx = int(np.argmax((r ** 2).sum(axis=1)))
            e_points.append(idx // p)
            Pt.append(idx)
            e_range.append(len(e_points))
            sel[k] = idx
            VT[:, k, :] = vk.T

        self.geom_Pt = np.array(Pt)
        self.geom_alpha = np.array(e_points)
        self.geom_alpha_ranges = np.array(e_range)
        self.geom_interpol_verts = np.array(self.geom_interpol_verts)

    @log_time
    def deim_blocksForm(self, device: bool | None = None):
        """Block DEIM: whole p-row blocks, on the backends of :meth:`deim`
        (the device loop ``ops/deim_scan.py`` ``deim_blocks``); duplicate
        device picks warn and re-run on the host."""
        p = self.nonlinearSnapshots.constraintsSize
        d = self.nonlinearSnapshots.dim
        K = self.numComp
        if device is None:
            device = _deim_device_auto(self.param, self.pod_mesh, K)
        if device:
            Pt, alphas, ranges = deim_blocks_host_result(
                self._device_comps().transpose(0, 1), p, K,
                device=self.device, mesh=self.pod_mesh)
            if len(np.unique(alphas)) < len(alphas):
                warnings.warn("device block-DEIM produced duplicate "
                              "selections (rank-deficient basis); falling "
                              "back to the host loop")
            else:
                self.geom_Pt = Pt
                self.geom_alpha = alphas
                self.geom_alpha_ranges = ranges
                self.geom_interpol_verts = np.array(
                    self.geom_interpol_verts)
                return
        bases = self.comps.swapaxes(0, 1)     # (ep, Kp, d)

        Pt: list[int] = []
        e_points: list[int] = []
        e_range: list[int] = []
        VT = np.empty((d, K * p, bases.shape[0]))
        sel = np.empty(K * p, dtype=np.int64)
        for k in range(K):
            kp = k * p
            vk = bases[:, kp:kp + p, :]       # (ep, p, d)
            if k == 0:
                r = vk
            else:
                c = np.empty(vk.shape)
                for i in range(d):
                    sol = np.linalg.lstsq(VT[i, :kp][:, sel[:kp]].T,
                                          vk[sel[:kp], :, i],
                                          rcond=None)[0]
                    c[:, :, i] = (sol.T @ VT[i, :kp]).T
                r = c - vk
                if np.allclose(r, 0):
                    warnings.warn(f"block-DEIM: zero residual at mode {k}; "
                                  f"truncating to {k} blocks")
                    self.comps = self.comps[:kp]
                    self._comps_device = None
                    self.numComp = k
                    break
            idx = int(np.argmax((r ** 2).sum(axis=(1, 2))))
            alpha = idx // p
            e_points.append(alpha)
            Pt.extend(alpha * p + m for m in range(p))
            e_range.append(len(e_points))
            sel[kp:kp + p] = alpha * p + np.arange(p)
            for i in range(d):
                VT[i, kp:kp + p] = vk[:, :, i].T

        self.geom_Pt = np.array(Pt)
        self.geom_alpha = np.array(e_points)
        self.geom_alpha_ranges = np.array(e_range)
        self.geom_interpol_verts = np.array(self.geom_interpol_verts)

    @log_time
    def geom_block_form_utilizing_differential_operator(
            self, error_in_pos_space: bool = False):
        """Geometric selection on the host: the interpolation set grows by
        the elements adjacent to the vertex of largest position-space
        residual (``error_in_pos_space``, at most ``geom_ele_per_vert`` new
        elements a step; for ``verts_bending`` through the constrained-
        vertex map), or by the element of largest residual block energy.
        Component k is the block of modes [k p, (k + 1) p)."""
        snaps = self.nonlinearSnapshots
        p = snaps.constraintsSize
        d = snaps.dim
        K = self.numComp
        bases = self.comps.swapaxes(0, 1)     # (ep, Kp, d)

        constrained_verts = None
        if error_in_pos_space and (
                self.param.constProj_snapshots_type == "verts_bending"):
            constrained_verts = np.load(
                self.param.constProj_input_snaps_constrained_elements
            )["indices"]

        Pt: list[int] = []
        e_points: list[int] = []
        e_jump: list[int] = []
        e_range: list[int] = []
        self.geom_interpol_verts = []
        V = None
        for k in range(K):
            vk = bases[:, k * p:(k + 1) * p, :]
            if k == 0:
                r = (self.St @ vk.reshape(vk.shape[0], -1)
                     if error_in_pos_space else vk)
            else:
                c = np.empty(vk.shape)
                for i in range(d):
                    sol = np.linalg.lstsq(V[Pt, :, i], vk[Pt, :, i],
                                          rcond=None)[0]
                    c[:, :, i] = V[:, :, i] @ sol
                r = c - vk
                if error_in_pos_space:
                    r = self.St @ r.reshape(r.shape[0], -1)
                if np.allclose(r, 0):
                    # the first k components span everything (or the
                    # modes ran out): truncate
                    warnings.warn(
                        f"geom selection: zero residual at component {k}; "
                        f"truncating basis from {K} to {k} components")
                    self.numComp = k
                    self.comps = self.comps[:k * p]
                    self._comps_device = None
                    break

            if error_in_pos_space:
                v = int(np.argmax((np.asarray(r) ** 2).sum(axis=1)))
                self.geom_interpol_verts.append(v)
                alpha_list = self._adjacent_elements(v)
                mapped = None
                if constrained_verts is not None:
                    alpha_list, mapped, _ = np.intersect1d(
                        constrained_verts, alpha_list, return_indices=True)
                jump = 0
                for al, alpha in enumerate(alpha_list):
                    if (alpha not in e_points
                            and jump < self.param.geom_ele_per_vert):
                        jump += 1
                        e_points.append(int(alpha))
                        if mapped is not None:
                            Pt.append(int(mapped[al]))   # p == 1 here
                        else:
                            Pt.extend(int(alpha) * p + m for m in range(p))
                e_jump.append(jump)
                e_range.append(int(np.sum(e_jump)))
            else:
                row_energy = (r ** 2).sum(axis=(1, 2))
                alpha = int(np.argmax(row_energy.reshape(-1, p).sum(axis=1)))
                if alpha in e_points:
                    raise RuntimeError(f"geom selection picked element "
                                       f"{alpha} twice")
                e_points.append(alpha)
                Pt.extend(alpha * p + m for m in range(p))
                e_jump.append(1)
                e_range.append(int(np.sum(e_jump)))

            V = vk if k == 0 else np.concatenate((V, vk), axis=1)

        self.geom_Pt = np.array(Pt)
        self.geom_alpha = np.array(e_points)
        self.geom_alpha_ranges = np.array(e_range)
        self.geom_interpol_verts = np.array(self.geom_interpol_verts)

    # ------------------------------------------------------------------
    # reconstruction and its errors
    # ------------------------------------------------------------------

    def geom_constructed(self, r: int, case: str = "train") -> np.ndarray:
        """The hyper-reduced reconstruction of every frame from the first r
        components and their interpolation rows (``geom_Pt``, as the JAX
        package reads them), one ``lstsq`` per dimension for all frames."""
        snaps = self.nonlinearSnapshots
        itype = self.param.constProj_bases_interpolation_type
        p = (snaps.constraintsSize
             if itype in ("geom", "deim_block_form") else 1)
        frames = (snaps.snapTensor if case == "train"
                  else snaps.test_snapTensor)
        if frames is None:
            raise ValueError(f"no {case} snapshots available")
        F, ep, _ = frames.shape
        V_r = self.comps.swapaxes(0, 1)[:, :r * p, :]   # (ep, rp, 3)
        n_elems = self.geom_alpha_ranges[r - 1]
        rows_per_elem = (p if (itype in ("geom", "deim_block_form")
                               and self.param.constProj_snapshots_type
                               != "verts_bending") else 1)
        Pt = self.geom_Pt[:n_elems * rows_per_elem]
        reconstructed = np.zeros((F, ep, 3))
        for l in range(3):
            A = V_r[Pt, :, l]                       # (m, rp)
            X = np.linalg.lstsq(A, frames[:, Pt, l].T, rcond=None)[0]
            reconstructed[:, :, l] = (V_r[:, :, l] @ X).T
        return reconstructed

    @staticmethod
    def frobenius_error(f, f_rec):
        return float(np.linalg.norm(f - f_rec))

    @staticmethod
    def relative_error_per_component(f, f_rec):
        out = []
        for i in range(3):
            denom = np.linalg.norm(f[:, :, i])
            err = np.linalg.norm(f[:, :, i] - f_rec[:, :, i])
            out.append(float(err / denom) if denom > 0 else 0.0)
        return out

    @staticmethod
    def max_pointwise_error(f, f_rec):
        return float(np.max(np.abs(f - f_rec)) / np.max(f))

    def test_basesSingVals(self) -> np.ndarray:
        s = np.empty((self.comps.shape[0], 3))
        for i in range(3):
            sv = np.linalg.svd(self.comps[:, :, i], compute_uv=False)
            s[:, i] = sv / sv.max()
        return s

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------

    @log_time
    def store_components_n_interpol_points(self):
        """The single ``.npz`` the reduced solver reads."""
        data = {
            "components": self.comps,
            "interpol_alphas": self.geom_alpha,
            "Pt": self.geom_Pt,
            "interpol_verts": self.geom_interpol_verts,
            "interpol_alpha_ranges": self.geom_alpha_ranges,
        }
        out = os.path.join(
            self.param.constProj_output_directory,
            "components_interpol_alphas_interpol_verts_interpol_alpha_ranges"
            ".npz")
        np.savez(out, **data)
        return out

    @log_time
    def store_components_gradually_to_files(self, start, end, step,
                                            file_type):
        snaps = self.nonlinearSnapshots
        p = snaps.constraintsSize
        n = snaps.num_constained_elements * p
        out_dir = self.param.constProj_output_directory
        base = os.path.join(out_dir, self.fileNameBases)
        points_base = os.path.join(out_dir, self.fileName_geom_points)
        verts_base = os.path.join(out_dir, "corrVerts")
        for k in range(start, end + 1, step):
            write_components(base, snaps.frs, k * p, n, 3,
                             self.comps[:k * p], file_type, "Kp")
            write_points_vector(
                points_base, snaps.frs, k,
                self.geom_alpha[:self.geom_alpha_ranges[k - 1]], file_type)
            if len(self.geom_interpol_verts):
                write_points_vector(verts_base, snaps.frs, k,
                                    self.geom_interpol_verts[:k], file_type)
