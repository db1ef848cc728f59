"""Position components: greedy deflation PCA and SPLOCS sparse localized
components over vertex-position snapshots.

Counterpart of ``animsnapbases_tpu/bases/pca.py``, with the tensor work on
the port's device in ``PIPELINE_DTYPE`` (float64): the global-support
extraction queues its K steps with no host sync (``bases/greedy.py``
``extract_global``); the local-support extraction and SPLOCS loop on the
host to query geodesic support maps (one vertex index read back per
component), around the same device steps (``bases/splocs.py``).  The
post-processing (``scipy.linalg.orth``), the error measures and the
stores run on the host, as in the JAX package.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from animsnapbases_tpu_torch.bases import greedy, splocs
from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device
from animsnapbases_tpu_torch.io.binfmt import write_components
from animsnapbases_tpu_torch.io.h5anim import write_components_h5
from animsnapbases_tpu_torch.snapshots.position import PositionSnapshots
from animsnapbases_tpu_torch.utils.checks import (
    is_linear_independent,
    sparsity_fractions,
    utmu_orthogonality_error,
)
from animsnapbases_tpu_torch.utils.timing import log_time


def compute_support_map(idx, geodesics, min_dist, max_dist):
    """Normalized clipped geodesic distance from ``idx``."""
    phi = geodesics(idx)
    return (np.clip(phi, min_dist, max_dist) - min_dist) / (max_dist - min_dist)


class PositionComponents:
    """Compute, post-process, and store position bases.

    Takes a ``BasesConfig`` (the snapshots read from its aligned .h5 files)
    or an explicit ``PositionSnapshots``; ``device`` (default the card)
    runs the extraction."""

    def __init__(self, param, pos_snapshots: PositionSnapshots | None = None,
                 device=None):
        from animsnapbases_tpu_torch.parallel.ensemble import (
            mesh_from_shards,
        )

        self.param = param
        self.device = resolve_device(device)
        self.basesType = param.vertPos_bases_type
        if self.basesType not in ("PCA", "SPLOCS"):
            raise ValueError(f"unknown position bases type {self.basesType}")
        # device_mesh_shards splits the global extraction's vertex axis
        self.pod_mesh = mesh_from_shards(
            getattr(param, "device_mesh_shards", 0), self.device)

        if pos_snapshots is None:
            train = os.path.join(param.aligned_snapshots_directory,
                                 param.train_aligned_snapshots_animation_file)
            test = os.path.join(param.aligned_snapshots_directory,
                                param.test_aligned_snapshots_animation_file)
            pos_snapshots = PositionSnapshots(
                train, test, param.vertPos_rest_shape,
                param.vertPos_masses_file, param.tet_mesh_file,
                standardize=param.q_standarize, mass_weight=param.q_massWeight,
                build_geodesics=(param.q_support == "local"
                                 or param.vertPos_bases_type == "SPLOCS"))
        self.pos_snapshots = pos_snapshots

        self.numComp = param.vertPos_numComponents
        self.support = param.q_support
        self.storeSingVal = param.store_vertPos_PCA_sing_val
        self.smooth_min_dist = param.vertPos_smooth_min_dist
        self.smooth_max_dist = param.vertPos_smooth_max_dist

        self.comps: np.ndarray | None = None   # (K, N, 3)
        self.weigs: np.ndarray | None = None   # (F, K)
        self.measures_at_largeDeforVerts: np.ndarray | None = None
        self.picks: np.ndarray | None = None   # (K,) the vertex of each step
        self.output_components_file = "components.h5"
        self.fileNameBases = "q_pos_"
        self._support_cache: dict[int, np.ndarray] = {}

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=PIPELINE_DTYPE,
                               device=self.device)

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------

    def _support_map(self, idx: int) -> np.ndarray:
        if idx not in self._support_cache:
            self._support_cache[idx] = compute_support_map(
                idx, self.pos_snapshots.compute_geodesic_distance,
                self.smooth_min_dist, self.smooth_max_dist)
        return self._support_cache[idx]

    @log_time
    def extract_k_components(self, writer=None):
        R0 = self._tensor(self.pos_snapshots.snapTensor)
        K = self.numComp

        if self.support == "local":
            comps, weights, measures, picks = self._extract_local(R0, K)
        else:
            C, W, sig, res, picks, _ = greedy.extract_global(
                R0, K, mesh=self.pod_mesh)
            picks = picks.cpu().numpy()
            comps = C.cpu().numpy()
            weights = W.cpu().numpy()
            measures = np.column_stack([np.arange(K), sig.cpu().numpy(),
                                        res.cpu().numpy()])
        if writer is not None:
            for row in measures:
                writer.writerow([int(row[0]), row[1], row[2]])

        self.comps = comps
        self.weigs = weights
        self.measures_at_largeDeforVerts = measures
        self.picks = picks

        if self.basesType == "SPLOCS":
            self.splocs_glob_optimization(self.param.splocs_max_itrs,
                                          self.param.splocs_admm_num_itrs)

    def _extract_local(self, R0, K):
        """Host loop: the support map around each step's argmax vertex (the
        one value read back a step); the tensor work on the device."""
        R = R0
        C, W, sig, res, picks = [], [], [], [], []
        for _ in range(K):
            idx = int(greedy.select_vertex(R))
            picks.append(idx)
            sigma0, wk = greedy.dominant_mode(R, idx)
            wk = greedy.signed_nonneg_weight(wk)
            s = 1.0 - self._support_map(idx)
            ck, R = greedy.deflate(R, wk, self._tensor(s))
            C.append(ck)
            W.append(wk)
            sig.append(sigma0)
            res.append(torch.linalg.vector_norm(R))
        measures = np.column_stack([np.arange(K),
                                    torch.stack(sig).cpu().numpy(),
                                    torch.stack(res).cpu().numpy()])
        return (torch.stack(C).cpu().numpy(),
                torch.stack(W, dim=1).cpu().numpy(), measures,
                np.array(picks))

    @log_time
    def splocs_glob_optimization(self, num_iters_max, num_admm_iterations):
        snaps = self.pos_snapshots
        F, N = snaps.frs, snaps.nVerts
        K = self.numComp
        Xflat = self._tensor(snaps.snapTensor).reshape(F, -1)
        C = self._tensor(self.comps)
        W = self._tensor(self.weigs)
        U = torch.zeros_like(C)
        Rflat = Xflat - W @ C.reshape(K, -1)

        rho = self.param.splocs_rho
        lam = self.param.splocs_lambda
        history = []
        for it in range(num_iters_max):
            Rflat, W = splocs.update_weights(Rflat, C.reshape(K, -1), W)
            # spatially varying regularization strength from support maps
            idxs = splocs.component_magnitude_argmax(C).cpu().numpy()
            Lambda = self._tensor(np.stack(
                [lam * self._support_map(int(i)) for i in idxs]))

            C, U, Z = splocs.admm_update(C, U, W, Xflat, Lambda, rho,
                                         num_admm_iterations)
            C = Z  # sparsity-inducing choice, as in Boyd et al.
            R, _, e_rms, energy = splocs.splocs_energy(Xflat, W, C, Lambda)
            Rflat = R.reshape(F, -1)
            history.append((it, float(energy), float(e_rms)))

        self.comps = C.cpu().numpy()
        self.weigs = W.cpu().numpy()
        self.splocs_history = history

    @log_time
    def compute_components_store_singvalues(self):
        header = ["component", "singVal", "norm_R"]
        if self.storeSingVal:
            file_name = os.path.join(
                self.param.vertPos_output_directory,
                self.param.name + "_posBases_pcaExtraction_singValues_errorNorm")
            with open(file_name + ".csv", "w", encoding="UTF8") as f:
                writer = csv.writer(f)
                writer.writerow(header)
                self.extract_k_components(writer)
        else:
            self.extract_k_components(None)

    # ------------------------------------------------------------------
    # post-processing
    # ------------------------------------------------------------------

    @log_time
    def post_process_components(self):
        snaps = self.pos_snapshots
        if self.param.q_standarize:
            self.comps = self.comps / snaps.pre_scale_factor
            self.comps = self.comps + snaps.mean[np.newaxis]

        if self.param.q_orthogonal:
            from scipy.linalg import orth
            self.rank_deficient_dims = []
            for l in range(self.comps.shape[2]):
                q = orth(self.comps[:, :, l].T).T      # (rank, N)
                if q.shape[0] < self.comps.shape[0]:
                    # degenerate input: keep the orthonormal set, zero-pad
                    # the rest
                    self.rank_deficient_dims.append(l)
                    pad = np.zeros((self.comps.shape[0] - q.shape[0],
                                    q.shape[1]))
                    q = np.concatenate([q, pad], axis=0)
                self.comps[:, :, l] = q

        if self.param.q_massWeight:
            if self.comps.shape[1] != snaps.invMassL.shape[0]:
                raise ValueError("components and masses differ in vertices")
            self.comps = self.comps * snaps.invMassL[:, None]

        self.sparsity = sparsity_fractions(self.comps)
        self.linear_independent = is_linear_independent(self.comps,
                                                        self.numComp)

    def is_utmu_orthogonal(self, atol: float = 1e-8) -> bool:
        err = utmu_orthogonality_error(self.comps, self.pos_snapshots.mass)
        return err < atol

    # ------------------------------------------------------------------
    # reconstruction / error measures
    # ------------------------------------------------------------------

    def reconstruct(self, k: int) -> np.ndarray:
        """Rank-k reconstruction W[:, :k] @ C[:k]."""
        return np.einsum("fk,knd->fnd", self.weigs[:, :k], self.comps[:k])

    @log_time
    def test_convergence(self, start, end, step):
        snaps = self.pos_snapshots.snapTensor
        fro, max_err = [], []
        rel = [[], [], []]
        for k in range(start, end + 1, step):
            rec = self.reconstruct(k)
            fro.append(self.frobenius_error(snaps, rec))
            r = self.relative_error_per_component(snaps, rec)
            for i in range(3):
                rel[i].append(r[i])
            max_err.append(self.max_pointwise_error(snaps, rec))
        return fro, max_err, rel[0], rel[1], rel[2]

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
        """Per-dim normalized singular values of the final (K, N) slices."""
        s = np.empty((self.comps.shape[0], 3))
        for i in range(3):
            sv = np.linalg.svd(self.comps[:, :, i], compute_uv=False)
            s[:, i] = sv / sv.max()
        return s

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------

    @log_time
    def store_components_to_files(self, start, end, step, file_type):
        snaps = self.pos_snapshots
        base = os.path.join(self.param.vertPos_output_directory,
                            self.fileNameBases)
        for k in range(start, end + 1, step):
            write_components(base, snaps.frs, k, snaps.nVerts, 3,
                             self.comps[:k], file_type, "K")

    @log_time
    def store_animations(self, output_dir):
        path = os.path.join(output_dir, self.output_components_file)
        write_components_h5(path, self.pos_snapshots.verts[0],
                            self.pos_snapshots.tris, self.comps)
