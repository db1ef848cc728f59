"""Constraint-projection components: POD bases and DEIM row selection.

Counterpart of the row form of ``animsnapbases_tpu/bases/constraints.py``
``ConstraintComponents``: ``pod_vectorized`` (one snapshot POD of the
flattened (e*p*3, F) snapshot matrix on the port's device, in float64),
the post-processing (standardization undone, orthogonalization, mass
weighting), row-wise DEIM on the JAX package's backends (the host float64
``lstsq`` loop below ``DEIM_DEVICE_MIN_K`` modes, the device scan of
``ops/deim_scan.py`` at and above, or as the config's ``deim_device``
says) with its two guards for a rank-deficient basis (the host loop
truncates at a zero residual; duplicate device picks re-run on the host;
each warns), and the ``.npz`` the reduced solver reads.

The per-slice ``pod``, the greedy block extractions (``pca_blocks``,
``pca_blocks_with_St``) and the block selections (``deim_blocksForm``,
``geom_block_form_utilizing_differential_operator``) are not ported yet
(ROADMAP Queue A item A8, its block forms): asking for them raises.
"""

from __future__ import annotations

import csv
import os
import warnings

import numpy as np
import torch

from animsnapbases_tpu_torch.device import resolve_device
from animsnapbases_tpu_torch.io.binfmt import (
    write_components,
    write_points_vector,
)
from animsnapbases_tpu_torch.ops.deim_scan import deim_rows_host_result
from animsnapbases_tpu_torch.ops.podlinalg import snapshot_pod
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

BLOCK_FORMS = ("the block forms of the bases are not ported to PyTorch yet "
               "(ROADMAP Queue A item A8, its block forms)")


def _deim_device_auto(param, K: int) -> bool:
    """The config's ``deim_device`` if set, else the scan at K >=
    DEIM_DEVICE_MIN_K."""
    flag = getattr(param, "deim_device", None)
    if flag is not None:
        return bool(flag)
    return K >= DEIM_DEVICE_MIN_K


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
        self.comps: np.ndarray | None = None   # (K, ep, 3)
        self.singVals: np.ndarray | None = None
        self._comps_device = None
        self.St = None

        self.geom_interpol_verts: list[int] = []
        self.geom_alpha = None
        self.geom_Pt = None
        self.geom_alpha_ranges = None

        self.fileNameBases = "p_nl_"
        self.fileName_geom_points = "p_nl_interpol_points_"
        self.file_name_sing = "_constrprojBases_pcaExtraction_singValues"

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
        if btype in ("pod", "pca_blocks", "pca_blocks_with_St"):
            raise NotImplementedError(f"basis type {btype!r}: {BLOCK_FORMS}")
        if btype != "pod_vectorized":
            raise ValueError(f"Unknown basis type: {btype}")
        if not self.storeSingVal:
            self.compute_pod_vectorized(None)
            return
        file_name = os.path.join(
            self.param.constProj_output_directory,
            self.param.name + "_" + self.param.constProj_name
            + self.file_name_sing)
        with open(file_name + ".csv", "w", encoding="UTF8") as f:
            writer = csv.writer(f)
            writer.writerow(["component", "singVal"])
            self.compute_pod_vectorized(writer)

    @log_time
    def compute_pod_vectorized(self, writer=None):
        """One snapshot POD of the flattened (e*p*3, F) matrix on the
        device; the kept modes stay there for a device DEIM."""
        R = self.nonlinearSnapshots.snapTensor
        F = R.shape[0]
        e = self.nonlinearSnapshots.num_constained_elements
        p = self.nonlinearSnapshots.constraintsSize
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
            device = _deim_device_auto(self.param, K)
        if device:
            Pt, alphas, ranges = deim_rows_host_result(
                self._device_comps().transpose(0, 1), p, K,
                device=self.device)
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

    def deim_blocksForm(self, device: bool | None = None):
        raise NotImplementedError(f"deim_blocksForm: {BLOCK_FORMS}")

    def geom_block_form_utilizing_differential_operator(self, *args,
                                                        **kwargs):
        raise NotImplementedError(
            f"geom_block_form_utilizing_differential_operator: {BLOCK_FORMS}")

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
