"""On-mesh accuracy: frame-by-frame comparison of full-order and reduced
simulation mesh sequences.

Counterpart of ``animsnapbases_tpu/analysis/accuracy.py`` (host numpy):
the per-vertex relative L2 error and the per-vertex normal angle error,
accumulated over frames and written to CSV, and the heat maps of those
per-vertex errors (matplotlib, imported by the function that draws).
Functions take arrays or tensors; a tensor is moved to the host once.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from animsnapbases_tpu_torch.geometry.mesh import vertex_normals
from animsnapbases_tpu_torch.io.meshes import load_mesh_auto


def _host(x) -> np.ndarray:
    """``x`` as a host array (a tensor copied to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def per_vertex_relative_l2(full, reduced):
    """(per-vertex error (N,), scalar mean): ||q_r - q_f|| / scene scale."""
    full, reduced = _host(full), _host(reduced)
    diff = np.linalg.norm(reduced - full, axis=1)
    scale = max(np.abs(full).max(), 1e-30)
    return diff / scale, float(diff.mean() / scale)


def normal_angle_error(full, reduced, faces):
    """Per-vertex angle (radians) between full and reduced normals ->
    (angles (N,), mean)."""
    faces = _host(faces)
    nf = vertex_normals(_host(full), faces)
    nr = vertex_normals(_host(reduced), faces)
    cos = np.clip((nf * nr).sum(axis=1), -1.0, 1.0)
    ang = np.arccos(cos)
    return ang, float(ang.mean())


def visualize_interpolation_elements_from_bin(mesh_path: str,
                                              geom_interpol_verts_file: str,
                                              geom_alpha_file: str,
                                              out_path: str,
                                              element_kind: str = "tris"):
    """Render the interpolation elements selected by the bases pipeline,
    read from the stored ``.bin`` vector -> the PNG's path."""
    from animsnapbases_tpu_torch.analysis.viewer import (
        view_interpolation_elements,
    )
    from animsnapbases_tpu_torch.geometry.mesh import tet_edges, unique_edges
    from animsnapbases_tpu_torch.io.binfmt import read_points_vector

    loaded = load_mesh_auto(mesh_path)
    if len(loaded) == 3:
        verts, tets, tris = loaded
    else:
        verts, tris = loaded
        tets = None
    alphas = read_points_vector(geom_alpha_file).astype(int)
    if element_kind == "tets" and tets is not None:
        elements = tets
    elif element_kind == "edges":
        elements = tet_edges(tets) if tets is not None else unique_edges(tris)
    else:
        elements = tris
    return view_interpolation_elements(verts, elements, alphas, out_path)


def compute_accuracy_arrays(full_seq, reduced_seq, faces):
    """In-memory twin of :func:`compute_accuracy` on (F, N, 3)
    trajectories -> (rows, rel_l2 (F, N), normal_angle (F, N)); the
    per-vertex arrays feed :func:`render_error_heatmaps`."""
    full_seq, reduced_seq = _host(full_seq), _host(reduced_seq)
    faces = _host(faces)
    rows, l2_maps, ang_maps = [], [], []
    for f_idx in range(len(full_seq)):
        l2_map, l2 = per_vertex_relative_l2(full_seq[f_idx],
                                            reduced_seq[f_idx])
        ang_map, ang = normal_angle_error(full_seq[f_idx],
                                          reduced_seq[f_idx], faces)
        rows.append({"frame": f_idx, "rel_l2": l2, "normal_angle": ang})
        l2_maps.append(l2_map)
        ang_maps.append(ang_map)
    return rows, np.asarray(l2_maps), np.asarray(ang_maps)


def render_error_heatmaps(verts_seq, faces, error_maps, out_dir: str,
                          frames, prefix: str = "accuracy",
                          cmap: str = "jet") -> list[str]:
    """Jet-colormap on-mesh error heat maps, one PNG per requested frame.
    ``error_maps`` is (F, N) per-vertex scalars; the color scale is shared
    across the rendered frames so that they compare."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from animsnapbases_tpu_torch.analysis.viewer import _render_mesh

    verts_seq, faces = _host(verts_seq), _host(faces)
    error_maps = _host(error_maps)
    frames = [int(f) for f in frames]
    if not frames:
        return []
    os.makedirs(out_dir, exist_ok=True)
    vmax = max(float(np.max([error_maps[f].max() for f in frames])), 1e-12)
    paths = []
    for f_idx in frames:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
        _render_mesh(ax, np.asarray(verts_seq[f_idx]), faces,
                     scalars=error_maps[f_idx], cmap=cmap,
                     vmin=0.0, vmax=vmax)
        sm = plt.cm.ScalarMappable(cmap=cmap,
                                   norm=plt.Normalize(0.0, vmax))
        fig.colorbar(sm, ax=ax, shrink=0.6, label=prefix)
        ax.set_title(f"{prefix} frame {f_idx}")
        path = os.path.join(out_dir, f"{prefix}_frame{f_idx:04d}.png")
        fig.savefig(path, dpi=140, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def compute_accuracy(full_pattern: str, reduced_pattern: str,
                     frames, faces=None, out_dir: str | None = None,
                     csv_name: str = "on_mesh_accuracy.csv"):
    """Compare sequences of mesh files frame by frame.

    ``full_pattern`` / ``reduced_pattern``: printf-style patterns with one
    integer slot (e.g. ``.../pos_%d.off``); ``frames``: the frame indices
    (a frame missing from either sequence is skipped).  Returns the list
    of per-frame dicts and writes a CSV when ``out_dir`` is given."""
    rows = []
    for f_idx in frames:
        try:
            vf, tf = load_mesh_auto(full_pattern % f_idx)[:2]
            vr, _ = load_mesh_auto(reduced_pattern % f_idx)[:2]
        except FileNotFoundError:
            continue
        use_faces = _host(faces) if faces is not None else tf
        _, l2 = per_vertex_relative_l2(vf, vr)
        _, ang = normal_angle_error(vf, vr, use_faces)
        rows.append({"frame": f_idx, "rel_l2": l2, "normal_angle": ang})

    if out_dir and rows:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, csv_name), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["frame", "rel_l2",
                                              "normal_angle"])
            w.writeheader()
            w.writerows(rows)
    return rows
