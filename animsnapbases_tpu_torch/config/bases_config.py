"""Bases-pipeline configuration.

Copy of ``animsnapbases_tpu/config/bases_config.py``: the reference's JSON
schema, the same derived attributes (snapshot patterns, the flags of the
string-token grammar, the self-describing output directories), directories
made only by :meth:`ensure_dirs`.  ``device_mesh_shards`` is read as
the JAX package reads it: the bases pipelines build their mesh from it
(``parallel/ensemble.py::mesh_from_shards``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any


def _get(cfg: dict, *keys, default=None):
    cur: Any = cfg
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


@dataclass
class BasesConfig:
    raw: dict = field(default_factory=dict)

    # ---- object ----
    name: str = ""
    experiment: str = ""
    snapshots_repo_dir: str = ""
    volumetric_mesh: bool = False
    snapshots_format: str = ".off"
    tet_mesh_file: str = ""
    tri_mesh_file: str = ""
    results_dir: str = "results"

    # ---- position bases ----
    compute_pos_bases: bool = False
    vertPos_testing: str = ""
    vertPos_rest_shape: str = "first"
    preAlignement: str = "_centered"
    rigid: bool = False
    frame_increment: int = 1
    train_test_jump: int = 1
    vertPos_numFrames: int = -1
    vertPos_numComponents: int = -1
    snapshots_folder: str = ""
    animation_folder: str = ""
    snapshots_anim_ready: bool = False
    visualize_snapshots: bool = False
    reduced_snapshots_available: bool = False
    vertPos_bases_type: str = "PCA"
    store_vertPos_PCA_sing_val: bool = False
    vertPos_smooth_min_dist: float = 0.1
    vertPos_smooth_max_dist: float = 0.25
    vertPos_masses_file: str = ""
    q_standarize: bool = False
    q_massWeight: bool = False
    q_orthogonal: bool = False
    q_support: str = "global"
    q_supported: bool = False
    splocs_max_itrs: int = 20
    splocs_admm_num_itrs: int = 10
    splocs_lambda: float = 2.0
    splocs_rho: float = 10.0
    run_pca_tests: bool = False
    visualize_bases: bool = False
    store_bases: bool = False

    # derived paths (position side)
    input_pos_snapshots_dir: str = ""
    input_snapshots_pattern: str = ""
    input_snapshots_files_name: str = ""
    input_animation_dir: str = ""
    train_snapshots_animation_file: str = ""
    test_snapshots_animation_file: str = ""
    train_aligned_snapshots_animation_file: str = ""
    test_aligned_snapshots_animation_file: str = ""
    aligned_snapshots_directory: str = ""
    vertPos_bases_name_extention: str = ""
    vertPos_output_directory: str = ""
    vertPos_output_animation_file: str = ""

    # ---- constraint-projection bases ----
    compute_constProj_bases: bool = False
    run_main_constProj_bases: bool = True
    constProj_name: str = ""
    constProj_element_type: str = ""
    constProj_dim: int = 3
    constProj_testing: str = ""
    constProj_rest_shape: str = "first"
    constProj_preAlignement: str = "_noAlignement"
    constProj_snapshots_type: str = ""
    constProj_numFrames: int = -1
    constProj_frame_increment: int = 1
    constProj_train_test_jump: int = 1
    bases_R_tol: float = 1e-20
    constProj_p_size: int = 1
    geom_ele_per_vert: int = 1 << 30
    constProj_store_sing_val: bool = False
    constProj_bases_interpolation_type: str = "deim"
    constProj_basis_type: str = "pod_vectorized"
    deim_desired_num_components: int = -1
    # >1: shard the bases compute over N ranks (parallel/ensemble.py)
    device_mesh_shards: int = 0
    # DEIM selection backend: True = the device scan (ops/deim_scan.py),
    # False = the host float64 lstsq loop, None = the JAX package's
    # default (the scan at K >= 64, the host loop below; duplicate device
    # picks re-run on the host)
    deim_device: bool | None = None
    constProj_standarize: bool = False
    constProj_massWeight: bool = False
    constProj_orthogonal: bool = False
    constProj_support: str = "global"
    reduced_constProj_snapshots_available: bool = False
    store_nonlinear_bases: bool = False
    run_geom_tests: bool = False
    visualize_geom_elements: bool = False
    visualize_geom_elements_at_K: int = 0
    costProj_St_key: str = ""

    # derived paths (constraint side)
    constProj_input_snapshots_pattern: str = ""
    constProj_input_snaps_constrained_elements: str = ""
    constProj_masses_file: str = ""
    constProj_weightedSt: str = ""
    constProj_bases_name_extention: str = ""
    constProj_output_directory: str = ""
    _pos_snaps_folder: str = ""
    _geom_pos_snaps_folder: str = ""

    # ------------------------------------------------------------------
    @classmethod
    def from_json(cls, json_file: str, results_dir: str = "results") -> "BasesConfig":
        with open(json_file) as fp:
            cfg = json.load(fp)
        return cls.from_dict(cfg, results_dir=results_dir)

    @classmethod
    def from_dict(cls, cfg: dict, results_dir: str = "results") -> "BasesConfig":
        self = cls(raw=cfg, results_dir=results_dir)
        obj = cfg["object"]
        self.snapshots_repo_dir = obj.get("experiment_dir", "")
        self.name = obj["mesh"]
        self.volumetric_mesh = obj.get("volumetric", False)
        self.experiment = obj.get("experiment", "")
        self.snapshots_format = obj.get("snap_format", ".off")
        self.tet_mesh_file = os.path.join(
            self.snapshots_repo_dir, self.name, self.name + ".mesh")
        self.tri_mesh_file = os.path.join(
            self.snapshots_repo_dir, self.name, self.name + ".obj")

        self._load_pos(cfg)
        self._load_constproj(cfg)
        return self

    # ------------------------------------------------------------------
    def _load_pos(self, cfg: dict) -> None:
        self.compute_pos_bases = bool(
            _get(cfg, "vertexPos_bases", "computeState", "compute", default=False))
        if not self.compute_pos_bases:
            return
        vp = cfg["vertexPos_bases"]
        self.vertPos_testing = _get(vp, "computeState", "testingComputations",
                                    default="_Release")
        self.vertPos_rest_shape = vp.get("rest_shape", "first")
        snaps = vp["snapshots"]
        self.preAlignement = snaps.get("preAlignement", "_centered")
        if self.preAlignement == "_alignedRigid":
            self.rigid = True
        elif self.preAlignement == "_centered":
            self.rigid = False
        else:
            raise ValueError(f"unknown alignment method: {self.preAlignement}")
        self.frame_increment = snaps.get("frame_increment", 1)
        self.snapshots_folder = snaps.get("snaps_folder", "")
        self.animation_folder = snaps.get("anims_folder", "")
        self.snapshots_anim_ready = snaps.get("anim_folder_ready", False)
        self.visualize_snapshots = snaps.get("visualize_aligned_animations", False)
        self.vertPos_numFrames = snaps["numFrames"]
        self.reduced_snapshots_available = snaps.get("reduced_snaps_available", False)
        self.vertPos_numComponents = vp["pca"]["numComponents"]

        base = os.path.join(self.snapshots_repo_dir, self.name, self.experiment)
        self.input_pos_snapshots_dir = os.path.join(base, "position_snapshots")
        self.input_snapshots_pattern = os.path.join(
            self.input_pos_snapshots_dir, self.snapshots_folder,
            "pos_*" + self.snapshots_format)
        self.input_snapshots_files_name = os.path.join(
            self.input_pos_snapshots_dir, self.snapshots_folder, "pos_")
        self.input_animation_dir = os.path.join(base, self.animation_folder)

        stem = (f"{self.vertPos_numFrames}_Frames_"
                f"{self.frame_increment}_increment_{self.preAlignement}.h5")
        self.train_snapshots_animation_file = "train_snapshots_" + stem
        self.test_snapshots_animation_file = "test_snapshots_" + stem
        self.train_aligned_snapshots_animation_file = "train_aligned_snapshots" + stem
        self.test_aligned_snapshots_animation_file = "test_aligned_snapshots" + stem

        self.vertPos_bases_type = ("SPLOCS" if _get(vp, "splocs", "compute",
                                                    default=False) else "PCA")
        self.store_vertPos_PCA_sing_val = vp["pca"].get("store_sing_val", False)
        self.vertPos_smooth_min_dist = _get(vp, "support", "min_dist", default=0.1)
        self.vertPos_smooth_max_dist = _get(vp, "support", "max_dist", default=0.25)
        self.vertPos_masses_file = os.path.join(
            self.snapshots_repo_dir, self.name,
            self.name + "_vertPos_massMatrix.bin")

        self.q_standarize = vp.get("standarized") == "_Standarized"
        self.q_massWeight = vp.get("massWeighted") == "_Volkwein"
        self.q_orthogonal = vp.get("orthogonalized") == "_Orthogonalized"
        if vp["pca"].get("supported") == "_Local":
            self.q_support, self.q_supported = "local", True
        else:
            self.q_support, self.q_supported = "global", False

        # self-describing output dir token grammar (ref config.py:332-351)
        self.vertPos_bases_name_extention = (
            self.vertPos_bases_type + self.preAlignement
            + vp.get("massWeighted", "") + vp.get("standarized", "")
            + vp["pca"].get("supported", "") + vp.get("orthogonalized", "")
            + self.vertPos_testing)
        self.vertPos_output_directory = os.path.join(
            self.results_dir, self.name, self.experiment, "q_bases",
            self.vertPos_bases_name_extention
            + f"{self.vertPos_numFrames}_Frames_"
            + f"{self.frame_increment}_increment_")
        self.aligned_snapshots_directory = os.path.join(
            self.results_dir, self.name, self.experiment, "q_snapshots_h5")
        self.vertPos_output_animation_file = (
            f"bases_animations{self.vertPos_numFrames}_Frames_computed_"
            f"{self.vertPos_numComponents}_bases.h5")

        self.visualize_bases = vp.get("visualize", False)
        self.store_bases = vp.get("store", False)
        splocs = vp.get("splocs", {})
        self.splocs_max_itrs = splocs.get("max_itrs", 20)
        self.splocs_admm_num_itrs = splocs.get("admm_num_itrs", 10)
        self.splocs_lambda = splocs.get("lambda", 2.0)
        self.splocs_rho = splocs.get("rho", 10.0)
        self.run_pca_tests = vp.get("run_tests", False)
        # sharded bases compute (position pipeline honours it too; the
        # constraintProj section may override)
        self.device_mesh_shards = vp.get(
            "device_mesh_shards", cfg.get("device_mesh_shards", 0))

    # ------------------------------------------------------------------
    def _load_constproj(self, cfg: dict) -> None:
        self.compute_constProj_bases = bool(
            _get(cfg, "constraintProj_bases", "computeState", "compute",
                 default=False))
        self.run_main_constProj_bases = bool(
            _get(cfg, "constraintProj_bases", "computeState", "run_main",
                 default=True))
        if not self.compute_constProj_bases:
            return
        cp = cfg["constraintProj_bases"]
        ctype = cp["constraintType"]
        self.constProj_name = ctype["name"]
        self.constProj_snapshots_type = ctype["name"]
        self.constProj_element_type = ctype.get("elements", "")
        self.constProj_dim = cp.get("dim", 3)
        self.constProj_testing = _get(cp, "computeState", "testingComputations",
                                      default="_Release")
        self.constProj_rest_shape = cp.get("rest_shape", "first")
        snaps = cp["snapshots"]
        self.constProj_preAlignement = snaps.get("preAlignement", "_noAlignement")
        self.reduced_constProj_snapshots_available = snaps.get(
            "reduced_snaps_available", False)
        self.constProj_frame_increment = snaps.get("frame_increment", 1)
        self.constProj_numFrames = snaps["numFrames"]
        self.constProj_train_test_jump = 1
        self.bases_R_tol = cp.get("bases_res_tol", 1e-20)
        self.constProj_p_size = ctype["rowSize"]
        self.geom_ele_per_vert = cp.get("max_element_per_geom_vert", 1 << 30)
        self.costProj_St_key = ctype.get("assembly_key", "")
        self.constProj_store_sing_val = cp.get("store_sing_val", False)
        self.constProj_bases_interpolation_type = cp.get("interpolation_type",
                                                         "deim")
        self.constProj_basis_type = cp.get("basis_type", "pod_vectorized")
        self.deim_desired_num_components = cp.get("desired_num_components", -1)
        self.device_mesh_shards = cp.get("device_mesh_shards",
                                          self.device_mesh_shards)
        self.deim_device = cp.get("deim_device", None)

        base = os.path.join(self.snapshots_repo_dir, self.name, self.experiment)
        p_folder = ctype.get("p_snaps_folder", "")
        self.constProj_input_snapshots_pattern = (
            base + p_folder + "/" + ctype.get("snaps_pattern_full_p", "").lstrip("/"))
        self.constProj_input_snaps_constrained_elements = (
            base + p_folder + "/" + ctype.get("constrained_elements", "").lstrip("/"))
        self.constProj_masses_file = os.path.join(
            self.snapshots_repo_dir, self.name,
            f"{self.name}_{self.constProj_name}_massMatrix.bin")
        self.constProj_weightedSt = (
            base + p_folder + "/" + ctype.get("assembly_file_name", ""))
        self._pos_snaps_folder = os.path.join(
            base, ctype.get("pos_snaps_folder", "").lstrip("/"))
        self._geom_pos_snaps_folder = os.path.join(
            base, ctype.get("geom_pos_snaps_folder", "").lstrip("/"))

        self.constProj_standarize = cp.get("standarized") == "_Standarized"
        self.constProj_massWeight = cp.get("massWeighted") == "_Volkwein"
        self.constProj_orthogonal = cp.get("orthogonalized") == "_Orthogonalized"
        self.constProj_support = ("local" if cp.get("supported") == "_Localized"
                                  else "global")

        self.constProj_bases_name_extention = (
            self.constProj_bases_interpolation_type + "_"
            + self.constProj_basis_type + self.constProj_preAlignement
            + cp.get("massWeighted", "") + cp.get("standarized", "")
            + cp.get("supported", "") + cp.get("orthogonalized", "")
            + self.constProj_testing)
        self.constProj_output_directory = os.path.join(
            self.results_dir, self.name, self.experiment, "p_bases",
            self.constProj_bases_name_extention
            + f"{self.constProj_numFrames}_Frames_"
            + f"{self.constProj_frame_increment}_increment",
            self.constProj_name)

        self.store_nonlinear_bases = cp.get("store_to_files", False)
        self.run_geom_tests = cp.get("run_tests", False)
        self.visualize_geom_elements = cp.get("visualize_geom_elements", False)
        self.visualize_geom_elements_at_K = cp.get(
            "visualize_elements_at_bases_num", 0)

    # ------------------------------------------------------------------
    def ensure_dirs(self) -> None:
        """Create output directories (explicit, unlike the reference which
        mkdirs inside config loading)."""
        for d in (self.vertPos_output_directory,
                  self.aligned_snapshots_directory,
                  self.input_animation_dir,
                  self.constProj_output_directory):
            if d:
                os.makedirs(d, exist_ok=True)
