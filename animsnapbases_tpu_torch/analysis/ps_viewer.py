"""Optional polyscope front-end for :class:`~animsnapbases_tpu_torch.demos.
interactive.InteractiveSession`.

Counterpart of ``animsnapbases_tpu/analysis/ps_viewer.py``.  The reference
drives its interactive demos through polyscope; here the binding is a thin
adapter: all physics, picking and panel logic lives in modules that know
no window system (``sim/interaction.py``, ``demos/interactive.py``), and
this file only translates polyscope events into those handlers.
polyscope is imported by :func:`require_polyscope` alone, when a window
is opened, never with the module; without it every entry point raises a
clear error, and headless rendering goes through ``analysis/viewer.py``.
"""

from __future__ import annotations

import numpy as np


def require_polyscope():
    """-> (polyscope, polyscope.imgui); ``RuntimeError`` when polyscope is
    not installed."""
    try:
        import polyscope as ps
        import polyscope.imgui as psim
    except ImportError as e:
        raise RuntimeError(
            "polyscope is not installed; interactive rendering is "
            "unavailable. Use animsnapbases_tpu_torch.analysis.viewer for "
            "headless PNG rendering, or install polyscope locally.") from e
    return ps, psim


class PolyscopeViewer:
    """Bind an InteractiveSession to a polyscope window.

    Mirrors the reference's loop: register the deformable surface, install a per-frame user callback that
    advances the solver and pushes the new vertex positions, and forward
    mouse clicks/drags to the picking handlers.
    """

    def __init__(self, session, steps_per_frame: int = 1):
        self.ps, self.psim = require_polyscope()
        self.session = session
        self.steps_per_frame = steps_per_frame
        self.animating = True
        self._surf = None
        self._down = None
        self._move = None

    # ------------------------------------------------------------------
    def _project(self, world_pts: np.ndarray) -> np.ndarray:
        """World -> screen coords via the current polyscope camera."""
        ps = self.ps
        view = np.asarray(ps.get_view_camera_parameters().get_view_mat())
        proj = np.asarray(ps.get_view_camera_parameters()
                          .get_projection_mat())
        w, h = ps.get_window_size()
        hom = np.concatenate([world_pts, np.ones((len(world_pts), 1))], 1)
        clip = hom @ view.T @ proj.T
        ndc = clip[:, :2] / np.maximum(np.abs(clip[:, 3:4]), 1e-12)
        return np.stack([(ndc[:, 0] + 1) * 0.5 * w,
                         (1 - ndc[:, 1]) * 0.5 * h], axis=1)

    # ------------------------------------------------------------------
    def _callback(self) -> None:
        psim = self.psim
        sess = self.session

        changed, self.animating = psim.Checkbox("animate", self.animating)
        if psim.Button("reset"):
            sess.reset()
            self._surf.update_vertex_positions(
                np.asarray(sess.model.positions))
            self._down, self._move = sess.mouse_handlers(self._project)
        psim.SameLine()
        if psim.Button("step"):
            sess.step(1)

        # panel toggles: gravity,
        # constraint sets, side fixing — 1:1 to InteractiveSession methods
        g_changed, g_on = psim.Checkbox(
            "gravity", sess.args.is_gravity_active)
        if g_changed:
            sess.set_gravity(g_on)
        for cname, flag in (("edge", "edge_constraint"),
                            ("tri_strain", "tri_strain_constraint"),
                            ("vert_bending", "vert_bending_constraint")):
            c_changed, c_on = psim.Checkbox(
                cname, bool(getattr(sess.args, flag, False)))
            if c_changed:
                sess.set_constraint(cname, c_on)
        for side in ("left", "right"):
            if psim.Button(f"fix {side}"):
                sess.fix_side(side)
            psim.SameLine()
            if psim.Button(f"release {side}"):
                sess.release_side(side)
        if psim.TreeNode("stats"):
            for k, v in sess.stats().items():
                psim.BulletText(f"{k}: {v}")
            psim.TreePop()

        # gestures: shift-click toggles a
        # pin + positional constraint, ctrl-click picks, ctrl-drag
        # converts the screen delta into a force on the picked vertex
        io = psim.GetIO()
        if io.MouseClicked[0]:
            x, y = io.MousePos
            self._down.handle_click(x, y, shift=io.KeyShift,
                                    ctrl=io.KeyCtrl)
        elif io.MouseDown[0]:
            x, y = io.MousePos
            self._move.handle_move(x, y)
        elif io.MouseReleased[0]:
            self._down.handle_release()

        if self.animating:
            sess.step(self.steps_per_frame)
        self._surf.update_vertex_positions(
            np.asarray(sess.model.positions))

    # ------------------------------------------------------------------
    def show(self) -> None:
        ps = self.ps
        ps.init()
        ps.set_up_dir("y_up")
        self._surf = ps.register_surface_mesh(
            "deformable", np.asarray(self.session.model.positions),
            np.asarray(self.session.model.faces))
        self._down, self._move = self.session.mouse_handlers(self._project)
        ps.set_user_callback(self._callback)
        ps.show()
        ps.clear_user_callback()


def show_session(session, steps_per_frame: int = 1) -> None:
    """Convenience entry point: ``show_session(InteractiveSession(args))``."""
    PolyscopeViewer(session, steps_per_frame).show()


# ---------------------------------------------------------------------------
# live basis viewers: polyscope equivalents of the reference's mayavi
# animation window and traitsui SPLOC component viewer; headless PNG
# twins live in analysis/viewer.py
# ---------------------------------------------------------------------------

def component_frame(rest: np.ndarray, comp: np.ndarray,
                    activation: float) -> np.ndarray:
    """Deformed positions for one component at the given activation."""
    return rest + activation * comp


class AnimationPlayer:
    """Play an animation ``.h5`` (``verts``/``tris`` schema) live with an
    imgui frame slider + play/pause, like the reference's mayavi window."""

    def __init__(self, h5_path: str, fps: int = 30):
        from animsnapbases_tpu_torch.io.h5anim import read_animation_h5

        self.verts, self.tris, _ = read_animation_h5(h5_path)
        self.frame = 0
        self.playing = True
        self.fps = fps
        self._surf = None
        self._last_advance = None

    def _callback(self) -> None:
        import time

        _, psim = require_polyscope()
        changed, self.frame = psim.SliderInt("frame", self.frame, 0,
                                             len(self.verts) - 1)
        _, self.playing = psim.Checkbox("play", self.playing)
        # wall-clock-paced playback (the render loop's rate is arbitrary)
        now = time.monotonic()
        if self.playing and not changed:
            if (self._last_advance is None
                    or now - self._last_advance >= 1.0 / self.fps):
                self.frame = (self.frame + 1) % len(self.verts)
                self._last_advance = now
        else:
            self._last_advance = now
        self._surf.update_vertex_positions(self.verts[self.frame])

    def show(self) -> None:
        ps, _ = require_polyscope()
        ps.init()
        ps.set_up_dir("y_up")
        self._surf = ps.register_surface_mesh("animation", self.verts[0],
                                              self.tris)
        ps.set_user_callback(self._callback)
        ps.show()
        ps.clear_user_callback()


class ComponentViewer:
    """Browse basis components live: component index + activation sliders,
    displacement magnitude as a vertex scalar (the reference's SPLOC
    viewer behavior)."""

    def __init__(self, components_h5: str):
        from animsnapbases_tpu_torch.io.h5anim import read_components_h5

        rest, tris, comps, names = read_components_h5(components_h5)
        self.rest = rest
        self.tris = tris
        self.comps = comps - rest[None]     # stored as rest + component
        self.names = list(names)
        self.index = 0
        self.activation = 1.0
        self._surf = None

    def _callback(self) -> None:
        _, psim = require_polyscope()
        _, self.index = psim.SliderInt("component", self.index, 0,
                                       len(self.comps) - 1)
        _, self.activation = psim.SliderFloat("activation", self.activation,
                                              -2.0, 2.0)
        if self.index < len(self.names):
            psim.TextUnformatted(str(self.names[self.index]))
        c = self.comps[self.index]
        self._surf.update_vertex_positions(
            component_frame(self.rest, c, self.activation))
        self._surf.add_scalar_quantity("|displacement|",
                                       np.linalg.norm(c, axis=1),
                                       enabled=True)

    def show(self) -> None:
        ps, _ = require_polyscope()
        ps.init()
        ps.set_up_dir("y_up")
        self._surf = ps.register_surface_mesh("components", self.rest,
                                              self.tris)
        ps.set_user_callback(self._callback)
        ps.show()
        ps.clear_user_callback()


def view_anim_live(h5_path: str, fps: int = 30) -> None:
    require_polyscope()
    AnimationPlayer(h5_path, fps).show()


def view_components_live(components_h5: str) -> None:
    require_polyscope()
    ComponentViewer(components_h5).show()


def rotating_capture_live(verts, tris, out_dir: str, selected=None,
                          interpol_verts=None, num_frames: int = 100,
                          prefix: str = "frame",
                          element_color=(0.5, 0.8, 0.5),
                          name: str = "mesh") -> list[str]:
    """Live polyscope rotating-camera capture, the reference's paper-figure
    generator: register the mesh (transparent), the interpolation-vertex
    point cloud and the highlighted elements, orbit the camera around the
    bounding-box center and screenshot every angle, then close the
    window.  Headless twin:
    :func:`animsnapbases_tpu_torch.analysis.viewer.view_rotating_capture`.
    Returns the written paths."""
    ps, _ = require_polyscope()
    import os

    verts = np.asarray(verts)
    os.makedirs(out_dir, exist_ok=True)
    ps.init()
    ps.set_ground_plane_mode("none")
    ps.register_surface_mesh(name, verts, np.asarray(tris)[:, :3],
                             transparency=0.18,
                             color=(0.89, 0.807, 0.565))
    if interpol_verts is not None and len(interpol_verts):
        ps.register_point_cloud(
            "interpolation vertices",
            verts[np.asarray(interpol_verts, dtype=int)], enabled=True,
            color=(0.9, 0.1, 0.25), radius=0.008)
    if selected is not None and len(selected):
        sel = np.asarray(selected, dtype=int)
        ps.register_surface_mesh("highlighted elements", verts,
                                 np.asarray(tris)[sel][:, :3],
                                 transparency=0.8, color=element_color)

    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    center = (lo + hi) / 2
    dist = 1.1 * float(np.linalg.norm(hi - lo))
    written = []
    frame = {"i": 0}

    def _callback():
        i = frame["i"]
        if i >= num_frames:
            ps.unshow()
            return
        a = np.radians(360.0 * (i + 1) / num_frames)
        ps.look_at((center[0] + dist * np.sin(a), center[1],
                    center[2] + dist * np.cos(a)), tuple(center))
        path = os.path.join(out_dir, f"{prefix}_{i:03d}.png")
        ps.screenshot(path, transparent_bg=False)
        written.append(path)
        frame["i"] = i + 1

    ps.set_user_callback(_callback)
    ps.show()
    ps.clear_user_callback()
    return written
