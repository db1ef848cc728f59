"""Bases CLI: ``python -m animsnapbases_tpu_torch.cli --config_file ...``.

Counterpart of ``animsnapbases_tpu/cli.py``.  Runs the position pipeline
(import an .off/.ply sequence into train and test .h5 animations, align
them, compute the PCA or SPLOCS bases, store the artifacts) and/or the
constraint-projection pipeline (recorded p snapshots -> POD or blockwise
bases -> DEIM or geom interpolation points -> one .npz), then the on-mesh
accuracy of a reduced run against the full-order one where both are
there, per the JSON config.  The bases are computed on ``device`` (the
card unless ``--cpu``; without one the run raises).  The test figures and
the rotating captures need matplotlib, ``.h5`` files h5py.
"""

from __future__ import annotations

import argparse
import os
import shutil
from functools import partial

import numpy as np


def _flush_timings(directory: str) -> None:
    """The stages' seconds as ``function_timings.txt``, also under the
    reference's relocated name ``time_logs.txt``."""
    from animsnapbases_tpu_torch.utils.timing import global_timer

    timings = global_timer().flush(directory)
    if timings is not None:
        shutil.copy(timings, os.path.join(directory, "time_logs.txt"))


def run_position_pipeline(param, device=None):
    """Import, align, extract, post-process and store the position bases
    of ``param`` (a ``BasesConfig``) on ``device`` (default the card) ->
    the ``PositionComponents``; with ``param.run_pca_tests`` the PCA test
    figures (:func:`~animsnapbases_tpu_torch.analysis.figures.plots_pca`)."""
    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.io.meshes import load_off, load_ply
    from animsnapbases_tpu_torch.snapshots.pipeline import (
        align_h5,
        import_sequence_to_h5,
    )

    dev = resolve_device(device)
    param.ensure_dirs()
    aligned_train = os.path.join(param.aligned_snapshots_directory,
                                 param.train_aligned_snapshots_animation_file)
    aligned_test = os.path.join(param.aligned_snapshots_directory,
                                param.test_aligned_snapshots_animation_file)

    if not (os.path.exists(aligned_train) and os.path.exists(aligned_test)):
        os.makedirs(param.input_animation_dir, exist_ok=True)
        train_h5 = os.path.join(param.input_animation_dir,
                                param.train_snapshots_animation_file)
        test_h5 = os.path.join(param.input_animation_dir,
                               param.test_snapshots_animation_file)
        if param.snapshots_format == ".off":
            loader = partial(load_off, no_colors=True)
        elif param.snapshots_format == ".ply":
            loader = load_ply
        else:
            raise ValueError(
                "only .off/.ply snapshot sequences are supported")
        import_sequence_to_h5(param.input_snapshots_pattern, train_h5,
                              param.vertPos_numFrames, param.frame_increment,
                              loader=loader)
        import_sequence_to_h5(param.input_snapshots_pattern, test_h5,
                              param.vertPos_numFrames,
                              param.frame_increment + param.train_test_jump,
                              loader=loader)
        align_h5(train_h5, aligned_train, param.rigid, device=dev)
        align_h5(test_h5, aligned_test, param.rigid, device=dev)
    else:
        print(f"aligned snapshot files exist, skipping import:"
              f"\n  {aligned_train}")

    bases = PositionComponents(param, device=dev)
    bases.compute_components_store_singvalues()
    bases.post_process_components()
    bases.store_animations(param.vertPos_output_directory)
    _flush_timings(param.vertPos_output_directory)

    if param.run_pca_tests:
        from animsnapbases_tpu_torch.analysis.figures import plots_pca
        plots_pca(bases, param)

    if param.store_bases:
        bases.store_components_to_files(1, bases.numComp, 1, ".bin")
    return bases


def export_rotation_captures(param, nl_bases, num_frames: int = 24) -> str:
    """Rotating-camera screenshot export of the selected interpolation
    elements (headless PNGs; the live polyscope twin is
    ``analysis.ps_viewer.rotating_capture_live``) -> the output
    directory."""
    from animsnapbases_tpu_torch.analysis.viewer import view_rotating_capture

    K = min(param.visualize_geom_elements_at_K,
            len(nl_bases.geom_alpha_ranges))
    snaps = nl_bases.nonlinearSnapshots
    sel = nl_bases.geom_alpha[:int(nl_bases.geom_alpha_ranges[K - 1])]
    out_dir = os.path.join(param.constProj_output_directory,
                           "rotation_scene_snapshots")
    view_rotating_capture(
        snaps.verts, snaps.tris, out_dir,
        selected=(sel if snaps.ele_type == "_tris" else None),
        interpol_verts=np.asarray(nl_bases.geom_interpol_verts)[:K],
        num_frames=num_frames,
        prefix=f"{param.name}_{param.constProj_name}_frame")
    return out_dir


def run_constproj_pipeline(param, device=None):
    """The constraint-projection bases of ``param`` on ``device`` (default
    the card): snapshots, components, post-processing and the interpolation
    points of ``param``'s type
    (:func:`~animsnapbases_tpu_torch.bases.pipeline.compute_constproj_bases`),
    then the timings, the ``.npz`` where ``param`` stores it; the rotating
    captures and the convergence figures where ``param`` asks for them
    -> the ``ConstraintComponents``."""
    from animsnapbases_tpu_torch.bases.pipeline import (
        compute_constproj_bases,
    )

    param.ensure_dirs()
    nl_bases = compute_constproj_bases(param, device=device)
    _flush_timings(param.constProj_output_directory)

    if param.store_nonlinear_bases:
        nl_bases.store_components_n_interpol_points()

    if (param.visualize_geom_elements
            and param.visualize_geom_elements_at_K > 0
            and getattr(nl_bases, "geom_alpha", None) is not None):
        out_dir = export_rotation_captures(param, nl_bases)
        print(f"rotation captures written to {out_dir}")

    if param.run_geom_tests:
        from animsnapbases_tpu_torch.analysis.figures import (
            plots_nonlinearity_basis,
        )

        steps = 1 if param.constProj_basis_type in ("pod", "pod_vectorized") \
            else 5
        pca_tests = param.constProj_basis_type in ("pca_blocks",
                                                   "pca_blocks_with_St")
        plots_nonlinearity_basis(nl_bases, pca_tests=pca_tests,
                                 postProcess_tests=True, geom_tests=True,
                                 steps=steps)
    return nl_bases


def run_on_mesh_accuracy(param):
    """Where reduced-simulation snapshots exist, compare them frame by
    frame against the full-order sequence -> {"pos"/"constproj": rows}."""
    from animsnapbases_tpu_torch.analysis.accuracy import compute_accuracy

    results = {}
    if param.compute_pos_bases and param.reduced_snapshots_available:
        results["pos"] = compute_accuracy(
            param.input_snapshots_files_name + "%d" + param.snapshots_format,
            os.path.join(param.input_pos_snapshots_dir, "posPCA", "pos_%d"
                         + param.snapshots_format),
            range(1, param.vertPos_numFrames + 1),
            out_dir=param.vertPos_output_directory)
    if (param.compute_constProj_bases
            and param.reduced_constProj_snapshots_available):
        results["constproj"] = compute_accuracy(
            os.path.join(param._pos_snaps_folder, "pos_%d"
                         + param.snapshots_format),
            os.path.join(param._geom_pos_snaps_folder, "pos_%d"
                         + param.snapshots_format),
            range(0, param.constProj_numFrames
                  * param.constProj_frame_increment,
                  param.constProj_frame_increment),
            out_dir=param.constProj_output_directory)
    return results


def main(param, device=None):
    """Both pipelines as ``param`` asks, then the on-mesh accuracy ->
    {"pos", "constproj", "accuracy"} (the ones that ran)."""
    results = {}
    if param.compute_pos_bases:
        print("Computing bases for position vertices")
        results["pos"] = run_position_pipeline(param, device=device)
    if param.compute_constProj_bases:
        print("Computing nonlinear bases")
        results["constproj"] = run_constproj_pipeline(param, device=device)
    accuracy = run_on_mesh_accuracy(param)
    if accuracy:
        results["accuracy"] = accuracy
    return results


def cli(argv=None):
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig

    parser = argparse.ArgumentParser(description="Set bases parameters.")
    parser.add_argument("--mesh", type=str, default="mesh")
    parser.add_argument(
        "--config_file", type=str,
        default="config/examples/cloth_strainOnly_automated_deim_"
                "triStrainSubspace.json")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--cpu", action="store_true",
                        help="compute the bases on the CPU (default: the "
                             "card, which must be present)")
    args = parser.parse_args(argv)

    param = BasesConfig.from_json(args.config_file,
                                  results_dir=args.results_dir)
    if param.run_main_constProj_bases or param.compute_pos_bases:
        main(param, device="cpu" if args.cpu else None)
    return param


if __name__ == "__main__":
    cli()
