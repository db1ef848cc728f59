"""The position-bases pipeline of the bases CLI.

Counterpart of ``run_position_pipeline`` of ``animsnapbases_tpu/cli.py``:
import an .off/.ply sequence into train and test .h5 animations, align
them (on the device), compute the PCA or SPLOCS bases on the device and
store the artifacts, per the JSON config.  The rest of the JAX CLI
(the constraint-projection branch's driver, ``main``, the rotating
captures) is ROADMAP Queue A item A15; the PCA test figures need
``analysis/figures.py`` (item A16).
"""

from __future__ import annotations

import os
import shutil
from functools import partial


def run_position_pipeline(param, device=None):
    """Import, align, extract, post-process and store the position bases
    of ``param`` (a ``BasesConfig``) on ``device`` (default the card) ->
    the ``PositionComponents``.  ``param.run_pca_tests`` raises
    ``NotImplementedError``: the test figures are ROADMAP item A16."""
    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.io.meshes import load_off, load_ply
    from animsnapbases_tpu_torch.snapshots.pipeline import (
        align_h5,
        import_sequence_to_h5,
    )
    from animsnapbases_tpu_torch.utils.timing import global_timer

    if param.run_pca_tests:
        raise NotImplementedError(
            "run_tests: the PCA test figures (analysis/figures.py "
            "plots_pca, matplotlib) are not ported yet (ROADMAP Queue A "
            "item A16)")
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
    # the stages' seconds, also under the reference's relocated name
    timings = global_timer().flush(param.vertPos_output_directory)
    if timings is not None:
        shutil.copy(timings, os.path.join(param.vertPos_output_directory,
                                          "time_logs.txt"))

    if param.store_bases:
        bases.store_components_to_files(1, bases.numComp, 1, ".bin")
    return bases
