"""Headless animation and component viewers.

Counterpart of ``animsnapbases_tpu/analysis/viewer.py``: the reference's
mayavi and polyscope viewers as functions that render to image files
through matplotlib (Agg), so that they work on hosts without a display;
each returns the written file paths.  matplotlib is imported by each
function, never with the module.
"""

from __future__ import annotations

import os

import numpy as np

from animsnapbases_tpu_torch.io.h5anim import (
    read_animation_h5,
    read_components_h5,
)


def _mpl():
    """(pyplot, Poly3DCollection) on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    return plt, Poly3DCollection


def _render_mesh(ax, verts, tris, scalars=None, cmap="viridis",
                 vmin=None, vmax=None):
    plt, Poly3DCollection = _mpl()
    polys = verts[np.asarray(tris)]
    if scalars is not None:
        face_vals = np.asarray(scalars)[np.asarray(tris)].mean(axis=1)
        norm = plt.Normalize(
            face_vals.min() if vmin is None else vmin,
            (face_vals.max() + 1e-12) if vmax is None else vmax)
        colors = plt.get_cmap(cmap)(norm(face_vals))
        pc = Poly3DCollection(polys, facecolors=colors, edgecolor="none")
    else:
        pc = Poly3DCollection(polys, facecolor=(0.55, 0.55, 0.85),
                              edgecolor=(0.3, 0.3, 0.3), linewidths=0.2)
    ax.add_collection3d(pc)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    c = (lo + hi) / 2
    r = (hi - lo).max() / 2 + 1e-9
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_axis_off()


def view_anim_file(h5_path: str, out_dir: str | None = None,
                   frames=None, prefix: str = "frame") -> list[str]:
    """Render animation frames to PNGs (the reference's mayavi animation
    window)."""
    plt, _ = _mpl()
    verts, tris, _ = read_animation_h5(h5_path)
    out_dir = out_dir or os.path.splitext(h5_path)[0] + "_frames"
    os.makedirs(out_dir, exist_ok=True)
    if frames is None:
        frames = range(0, len(verts), max(1, len(verts) // 8))
    written = []
    for f in frames:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
        _render_mesh(ax, verts[f], tris)
        path = os.path.join(out_dir, f"{prefix}_{f:04d}.png")
        fig.savefig(path, dpi=90)
        plt.close(fig)
        written.append(path)
    return written


def view_components(components_h5: str, out_dir: str | None = None,
                    components=None, activation: float = 1.0) -> list[str]:
    """Render each component as rest + activation * component with the
    displacement magnitude as color (the reference's traitsui SPLOC
    viewer)."""
    plt, _ = _mpl()
    rest, tris, comps, names = read_components_h5(components_h5)
    comps = comps - rest[None]   # stored as rest + component
    out_dir = out_dir or os.path.splitext(components_h5)[0] + "_components"
    os.makedirs(out_dir, exist_ok=True)
    if components is None:
        components = range(len(comps))
    written = []
    for i in components:
        c = comps[i]
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
        magnitude = np.linalg.norm(c, axis=1)
        _render_mesh(ax, rest + activation * c, tris, scalars=magnitude,
                     cmap="coolwarm")
        ax.set_title(names[i] if i < len(names) else f"comp{i:03d}")
        path = os.path.join(out_dir, f"component_{i:03d}.png")
        fig.savefig(path, dpi=90)
        plt.close(fig)
        written.append(path)
    return written


def view_interpolation_elements(verts, elements, selected, out_path: str,
                                element_color=(0.5, 0.8, 0.5),
                                max_background_faces: int = 20_000) -> str:
    """Highlight selected constrained elements on the mesh (the
    reference's polyscope element visualizer).  Large background surfaces
    are thinned by vertex-clustering decimation for rendering speed (the
    reference decimates with igl); selected elements always draw on the
    original mesh."""
    plt, Poly3DCollection = _mpl()
    verts = np.asarray(verts)
    elements = np.asarray(elements)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    if elements.shape[1] >= 3:
        tris = elements[:, :3]
        if len(tris) > max_background_faces:
            from animsnapbases_tpu_torch.geometry.mesh import (
                decimate_to_face_ratio,
            )
            bg_v, bg_f = decimate_to_face_ratio(
                verts, tris, max_background_faces / len(tris))
            _render_mesh(ax, bg_v, bg_f)
        else:
            _render_mesh(ax, verts, tris)
        sel = elements[np.asarray(selected, dtype=int)][:, :3]
        pc = Poly3DCollection(verts[sel], facecolors=[element_color],
                              edgecolor="k", linewidths=0.5)
        ax.add_collection3d(pc)
    else:  # edges
        for e in elements[np.asarray(selected, dtype=int)]:
            seg = verts[e]
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], color=element_color,
                    lw=2)
    fig.savefig(out_path, dpi=90)
    plt.close(fig)
    return out_path


def view_rotating_capture(verts, tris, out_dir: str, selected=None,
                          interpol_verts=None, element_kind: str = "tris",
                          num_frames: int = 24, prefix: str = "frame",
                          elev: float = 18.0,
                          element_color=(0.5, 0.8, 0.5),
                          edges=None) -> list[str]:
    """Rotating-camera screenshot export of a mesh with (optionally) the
    selected interpolation elements highlighted: headless twin of the
    reference's polyscope rotation capture (the mesh, the interpolation
    vertices and the highlighted elements, the camera around the
    bounding-box center, ``num_frames`` angles).  Writes
    ``{prefix}_{i:03d}.png`` per azimuth and returns the paths.

    ``tris`` always renders the background surface.  ``selected``:
    indices into ``tris`` — or, for ``element_kind='edges'``, into the
    (m, 2) ``edges`` array (pass it separately so the background mesh
    still draws; with ``edges=None`` the highlight falls back to each
    selected triangle's first edge).  ``interpol_verts``: vertex indices
    drawn as a point cloud (the DEIM/geom pick set)."""
    plt, Poly3DCollection = _mpl()
    verts = np.asarray(verts)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in range(num_frames):
        azim = 360.0 * i / num_frames
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(111, projection="3d")
        if tris is not None and len(tris):
            _render_mesh(ax, verts, np.asarray(tris)[:, :3])
        if selected is not None and len(selected):
            sel = np.asarray(selected, dtype=int)
            if element_kind == "edges":
                src = edges if edges is not None else tris
                for e in np.asarray(src)[sel] if src is not None else []:
                    seg = verts[np.asarray(e[:2], dtype=int)]
                    ax.plot(seg[:, 0], seg[:, 1], seg[:, 2],
                            color=element_color, lw=2)
            else:
                faces = np.asarray(tris)[sel][:, :3]
                pc = Poly3DCollection(verts[faces],
                                      facecolors=[element_color],
                                      edgecolor="k", linewidths=0.5)
                ax.add_collection3d(pc)
        if interpol_verts is not None and len(interpol_verts):
            pts = verts[np.asarray(interpol_verts, dtype=int)]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2],
                       color=(0.9, 0.1, 0.25), s=18, depthshade=False)
        ax.view_init(elev=elev, azim=azim)
        path = os.path.join(out_dir, f"{prefix}_{i:03d}.png")
        fig.savefig(path, dpi=90)
        plt.close(fig)
        written.append(path)
    return written


def view_element_selection(verts, faces, picked_verts,
                           element_type: str = "verts",
                           out_path: str | None = None, tets=None,
                           vertex_color=(1.0, 0.0, 0.0),
                           element_color=(0.6, 0.2, 0.62),
                           max_background_faces: int = 20_000) -> str:
    """Standalone element visualizer, headless twin of the reference's
    ``visualize_tet_mesh_elements``: picked vertices as a red point cloud plus, per ``element_type``,

    * ``verts``: the picked vertices' one-ring neighbor vertices,
    * ``edges``: surface edges touching any picked vertex,
    * ``tris``/``faces``: faces containing any picked vertex,
    * ``tets``: tetrahedra containing any picked vertex (outlined by
      their face triangles).
    """
    plt, Poly3DCollection = _mpl()
    verts = np.asarray(verts)
    faces = np.asarray(faces) if faces is not None else None
    picked = np.atleast_1d(np.asarray(picked_verts, dtype=int))
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")

    bg_v, bg_f = verts, faces
    if faces is not None and len(faces) > max_background_faces:
        from animsnapbases_tpu_torch.geometry.mesh import (
            decimate_to_face_ratio,
        )
        bg_v, bg_f = decimate_to_face_ratio(
            verts, faces, max_background_faces / len(faces))
    if bg_f is not None and len(bg_f):
        _render_mesh(ax, bg_v, bg_f)

    pts = verts[picked]
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color=[vertex_color],
               s=24, depthshade=False)

    if element_type == "verts" and faces is not None:
        mask = np.isin(faces, picked).any(axis=1)
        nbrs = np.setdiff1d(np.unique(faces[mask]), picked)
        if len(nbrs):
            npts = verts[nbrs]
            ax.scatter(npts[:, 0], npts[:, 1], npts[:, 2],
                       color=[element_color], s=18, depthshade=False)
    elif element_type == "edges" and faces is not None:
        mask = np.isin(faces, picked).any(axis=1)
        for f in faces[mask]:
            for a, b in ((0, 1), (1, 2), (2, 0)):
                if f[a] in picked or f[b] in picked:
                    seg = verts[[f[a], f[b]]]
                    ax.plot(seg[:, 0], seg[:, 1], seg[:, 2],
                            color=element_color, lw=1.5)
    elif element_type in ("tris", "faces") and faces is not None:
        mask = np.isin(faces, picked).any(axis=1)
        if mask.any():
            pc = Poly3DCollection(verts[faces[mask][:, :3]],
                                  facecolors=[element_color],
                                  edgecolor=(0.10, 0.45, 0.95),
                                  linewidths=0.5)
            ax.add_collection3d(pc)
    elif element_type == "tets":
        if tets is None:
            raise ValueError("element_type='tets' needs a tets array")
        tets = np.asarray(tets)
        mask = np.isin(tets, picked).any(axis=1)
        tri_of_tet = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
        tfaces = tets[mask][:, tri_of_tet].reshape(-1, 3)
        if len(tfaces):
            pc = Poly3DCollection(verts[tfaces],
                                  facecolors=[element_color], alpha=0.45,
                                  edgecolor="k", linewidths=0.3)
            ax.add_collection3d(pc)
    else:
        raise ValueError(f"unknown element_type {element_type!r}")

    out_path = out_path or "element_selection.png"
    fig.savefig(out_path, dpi=90)
    plt.close(fig)
    return out_path
