"""Snapshot import: mesh sequence -> preprocessed .h5 animation ->
rigid or centered aligned .h5.

Counterpart of ``animsnapbases_tpu/snapshots/pipeline.py``: zero-area
triangle removal, largest-connected-component filtering, normalization
into the ±0.5 cube and natural filename sorting on the host (numpy), and
every frame's Procrustes alignment at once on the device
(``geometry/procrustes.py``).  The sequence is read with the Python
loaders of ``io/meshes.py``.  :func:`import_frames` and
:func:`align_animation` take arrays, so that a recording in memory takes
the same steps as a sequence of files without ``h5py``.
"""

from __future__ import annotations

import os
import re
from glob import glob

import numpy as np

from animsnapbases_tpu_torch.geometry.mesh import (
    filter_reindex,
    largest_component_mask,
)
from animsnapbases_tpu_torch.geometry.procrustes import align_animation
from animsnapbases_tpu_torch.io.h5anim import (
    read_animation_h5,
    write_animation_h5,
)
from animsnapbases_tpu_torch.io.meshes import load_mesh_auto


def _alphanum_key(s: str):
    return [int(c) if c.isdigit() else c for c in re.split(r"([0-9]+)", s)]


def sort_nicely(files: list[str]) -> None:
    """In-place natural sort ('pos_10' after 'pos_2')."""
    files.sort(key=_alphanum_key)


def preprocess_mesh_animation(verts: np.ndarray, tris: np.ndarray):
    """Drop zero-area triangles, keep the biggest connected component, and
    normalize the animation into the -0.5..0.5 cube.

    Returns (verts, tris, dropped_mask, verts_mean, verts_scale).
    """
    verts = np.asarray(verts)
    tris = np.asarray(tris, dtype=np.int64)
    if verts.ndim != 3 or tris.ndim != 2:
        raise ValueError("expected verts (F, N, 3) and tris (M, 3)")

    e1 = verts[0, tris[:, 1]] - verts[0, tris[:, 0]]
    e2 = verts[0, tris[:, 2]] - verts[0, tris[:, 0]]
    n = np.cross(e1, e2)
    tris = tris[np.linalg.norm(n, axis=1) > 1e-8]

    keep = largest_component_mask(verts.shape[1], tris)
    verts = verts[:, keep, :]
    tris = filter_reindex(keep, tris[keep[tris].all(axis=1)])

    verts_mean = verts.mean(axis=0).mean(axis=0)
    verts = verts - verts_mean
    verts_scale = np.abs(np.ptp(verts, axis=1)).max()
    verts = verts / verts_scale
    return verts, tris, ~keep, verts_mean, verts_scale


def import_frames(verts_all, tris):
    """A sequence's frames (F, N, 3), stored as float32 as the import
    stores them, then preprocessed (:func:`preprocess_mesh_animation`) ->
    (verts float32, tris, mean, scale): what the animation .h5 holds."""
    verts_all = np.array(verts_all, np.float32)
    verts, tris, _, mean, scale = preprocess_mesh_animation(verts_all, tris)
    return verts.astype(np.float32), tris, mean, scale


def import_sequence_to_h5(filename_pattern: str, h5_output_file: str,
                          max_frames: int, increment: int,
                          loader=None) -> None:
    """Load every ``increment``-th mesh of a sorted sequence (up to
    ``max_frames``), preprocess, and write the animation .h5."""
    files = glob(os.path.expanduser(filename_pattern))
    sort_nicely(files)
    selected = [f for i, f in enumerate(files) if i % increment == 0]
    selected = selected[:max_frames]
    if not selected:
        raise FileNotFoundError(f"no meshes matched {filename_pattern}")
    if loader is None:
        loader = load_mesh_auto
    verts_all = []
    tris = None
    for f in selected:
        verts, new_tris = loader(f)
        if tris is not None and (new_tris.shape != tris.shape
                                 or (new_tris != tris).any()):
            raise ValueError("inconsistent topology between meshes of "
                             "different frames")
        tris = new_tris
        verts_all.append(verts)
    verts, tris, mean, scale = import_frames(verts_all, tris)
    write_animation_h5(h5_output_file, verts, tris, mean=mean, scale=scale)


def align_h5(input_h5: str, output_h5: str, rigid: bool,
             device=None) -> None:
    """Align all frames to frame 0 (rigid or translation-only) on
    ``device`` and write the aligned animation."""
    verts, tris, _ = read_animation_h5(input_h5)
    aligned = align_animation(verts, rigid=rigid, device=device)
    write_animation_h5(output_h5, aligned, tris)
