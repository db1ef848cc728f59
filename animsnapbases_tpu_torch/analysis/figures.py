"""Diagnostic figures and CSVs of the bases computations.

Counterpart of ``animsnapbases_tpu/analysis/figures.py``: singular values
at the extraction vertices, residual decay, per-dimension normalized
singular values of the final bases, and reconstruction-convergence curves
on train and held-out test snapshots.  The numbers and CSV files come from
functions that draw nothing (:func:`pca_diagnostics`,
:func:`nonlinearity_diagnostics`), so that a host without matplotlib can
compute them; :func:`plots_pca` and :func:`plots_nonlinearity_basis` call
them, draw the figures (matplotlib, Agg, imported when they draw) and
return what the JAX functions return.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from animsnapbases_tpu_torch.utils.checks import (
    is_linear_independent,
    sparsity_fractions,
)


def _write_csv(path, header, rows):
    with open(path, "w", encoding="UTF8", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for row in rows:
            w.writerow(row)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def pca_diagnostics(bases, param, out_dir: str | None = None) -> dict:
    """The position bases' diagnostics without drawing: writes
    ``posBases_singvals.csv`` -> {"measures", "k_values", "sparsity",
    "linear_independent", "sing_vals", "out_dir"}."""
    out_dir = out_dir or param.vertPos_output_directory
    os.makedirs(out_dir, exist_ok=True)
    measures = np.asarray(bases.measures_at_largeDeforVerts, dtype=float)
    k_values = np.arange(1, measures.shape[0] + 1)
    s = bases.test_basesSingVals()
    _write_csv(os.path.join(out_dir, "posBases_singvals.csv"),
               ["k", "sing", "norm_R"],
               [[int(k), m[1], m[2]] for k, m in zip(k_values, measures)])
    return {
        "measures": measures,
        "k_values": k_values,
        "sparsity": sparsity_fractions(bases.comps),
        "linear_independent": is_linear_independent(bases.comps,
                                                    bases.comps.shape[0]),
        "sing_vals": s,
        "out_dir": out_dir,
    }


def plots_pca(bases, param, out_dir: str | None = None) -> dict:
    """3-panel PCA diagnostics for position bases + sparsity/rank checks.
    Returns the computed diagnostic values."""
    d = pca_diagnostics(bases, param, out_dir)
    measures, k_values, s = d["measures"], d["k_values"], d["sing_vals"]
    plt = _pyplot()

    fig, axes = plt.subplots(1, 3, figsize=(20, 6))
    axes[0].plot(k_values, measures[:, 1] / measures[:, 1].max(), "bo",
                 ls="-.")
    axes[0].set_xlabel("Reduction Dimension (r)")
    axes[0].set_ylabel("Normalized $\\sigma$")
    axes[0].set_title("singVals at large-deformation points")

    axes[1].plot(k_values, measures[:, 2], "rv", ls="-")
    axes[1].set_xlabel("Reduction Dimension (r)")
    axes[1].set_ylabel("Fro. norm")
    axes[1].set_title("norm(R) during PCA extraction")

    for dim, (mark, lbl) in enumerate(zip("brg", "xyz")):
        axes[2].plot(np.arange(1, s.shape[0] + 1), s[:, dim], mark + "o",
                     ls="--", label=f"$\\sigma_{lbl}$")
    axes[2].legend()
    axes[2].set_title("Normalized singVal(bases), full K range")

    fig_path = os.path.join(d["out_dir"],
                            "posBases_pca_extraction_tests.png")
    fig.savefig(fig_path)
    plt.close(fig)

    return {
        "figure": fig_path,
        "sparsity": d["sparsity"],
        "linear_independent": d["linear_independent"],
        "sing_vals": s,
    }


def nonlinearity_diagnostics(nl_bases, pca_tests=True,
                             postProcess_tests=True, geom_tests=True,
                             steps: int = 5,
                             out_dir: str | None = None) -> dict:
    """The constraint bases' diagnostics without drawing: the
    reconstruction convergence on the train and test tensors, written to
    ``<interpolation>_<basis>_convergence_tests_{train,test}.csv``, and the
    post-processing checks -> {"out_dir", "measures" (or None),
    "convergence" (when ``geom_tests``), "sparsity", "linear_independent",
    "utmu_orthogonal" (when asked and orthogonalized)}."""
    param = nl_bases.param
    out_dir = out_dir or param.constProj_output_directory
    os.makedirs(out_dir, exist_ok=True)
    out = {"out_dir": out_dir, "measures": None}
    if pca_tests and nl_bases.measures_at_largeDeforVerts is not None:
        out["measures"] = np.asarray(nl_bases.measures_at_largeDeforVerts,
                                     dtype=float)

    if geom_tests:
        k = nl_bases.numComp
        r_values = list(range(1, k + 1, steps)) or [1]
        if r_values[-1] != k:
            r_values.append(k)
        rows = {"train": [], "test": []}
        for case in ("train", "test"):
            f = (nl_bases.nonlinearSnapshots.snapTensor if case == "train"
                 else nl_bases.nonlinearSnapshots.test_snapTensor)
            if f is None:
                continue
            for r in r_values:
                rec = nl_bases.geom_constructed(r, case)
                fro = nl_bases.frobenius_error(f, rec)
                mx = nl_bases.max_pointwise_error(f, rec)
                rel = nl_bases.relative_error_per_component(f, rec)
                rows[case].append([r, fro, mx, *rel])
            _write_csv(
                os.path.join(
                    out_dir, f"{param.constProj_bases_interpolation_type}"
                    f"_{param.constProj_basis_type}"
                    f"_convergence_tests_{case}.csv"),
                ["numPoints", "fro_error", "max_err", "relative_errors_x",
                 "relative_errors_y", "relative_errors_z"],
                rows[case])
        out["convergence"] = rows

    if postProcess_tests:
        out["sparsity"] = sparsity_fractions(nl_bases.comps)
        out["linear_independent"] = nl_bases.linear_independent()
        if param.constProj_orthogonal:
            out["utmu_orthogonal"] = nl_bases.is_utmu_orthogonal()
    return out


def plots_nonlinearity_basis(nl_bases, pca_tests=True, postProcess_tests=True,
                             geom_tests=True, steps: int = 5,
                             out_dir: str | None = None) -> dict:
    """Reconstruction-convergence diagnostics for constraint bases on train
    AND held-out test tensors; interpolation-element-count plot; CSVs."""
    d = nonlinearity_diagnostics(nl_bases, pca_tests, postProcess_tests,
                                 geom_tests, steps, out_dir)
    param = nl_bases.param
    out_dir = d["out_dir"]
    plt = _pyplot()
    results = {}

    if d["measures"] is not None:
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(d["measures"][:, 2], "rv", ls="-", label="$\\|R\\|_F$")
        ax.set_xlabel("component")
        ax.legend()
        p = os.path.join(out_dir, "constrprojBases_pca_extraction_tests.png")
        fig.savefig(p)
        plt.close(fig)
        results["pca_figure"] = p

    if geom_tests:
        rows = d["convergence"]
        fig, axes = plt.subplots(1, 2, figsize=(16, 6))
        for case, marker in (("train", "o"), ("test", "x")):
            if not rows[case]:
                continue
            arr = np.asarray(rows[case])
            axes[0].semilogy(arr[:, 0], arr[:, 1], marker=marker,
                             label=f"Frobenius ({case})")
            axes[1].semilogy(arr[:, 0], arr[:, 3] + arr[:, 4] + arr[:, 5],
                             marker=marker, label=f"sum rel err ({case})")
        for ax in axes:
            ax.set_xlabel("Reduction Dimension (r)")
            ax.legend()
        p = os.path.join(
            out_dir, f"constrproj_{param.constProj_bases_interpolation_type}"
            f"_{param.constProj_basis_type}_reconstruction_norms_tests.png")
        fig.savefig(p)
        plt.close(fig)
        results["convergence_figure"] = p
        results["convergence"] = rows

        if nl_bases.geom_alpha_ranges is not None:
            fig, ax = plt.subplots(figsize=(10, 6))
            ax.plot(nl_bases.geom_alpha_ranges, "bo", ls="--",
                    label="0 < elements < e")
            ax.set_xlabel("Reduction Dimension (r)")
            ax.set_ylabel("number of elements")
            ax.legend()
            p = os.path.join(
                out_dir, f"{param.constProj_bases_interpolation_type}"
                f"_{param.constProj_basis_type}_numberOfElements.png")
            fig.savefig(p)
            plt.close(fig)
            results["elements_figure"] = p

    for key in ("sparsity", "linear_independent", "utmu_orthogonal"):
        if key in d:
            results[key] = d[key]
    return results
