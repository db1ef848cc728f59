"""The interactive session, the mouse handlers, the per-frame handler and
the live polyscope app of the port (``demos/interactive.py``,
``sim/interaction.py``, ``analysis/ps_viewer.py``, ``sim_cli --view``)
against the JAX package's under the same events, on the CPU in float64,
with a stubbed ``polyscope``."""

import importlib
import os
import sys
import types

import numpy as np
import pytest

from animsnapbases_tpu.demos.interactive import (
    InteractiveSession as JaxSession,
)
from animsnapbases_tpu_torch.demos.interactive import InteractiveSession
from test_torch_scenarios import EXTENT_TOL, one_thread, small_args  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sessions(tmp_path, **kw):
    """(JAX session, port session) on the small cloth."""
    jp, ja = small_args(tmp_path, jax=True, **kw)
    pp, pa = small_args(tmp_path, **kw)
    return (JaxSession(ja, "Cloth", params=jp),
            InteractiveSession(pa, "Cloth", params=pp, device="cpu"))


def assert_same(js, ps):
    A, P = js.model.positions, ps.model.positions
    assert float(np.abs(A - P).max()) <= EXTENT_TOL * float(np.abs(A).max())
    np.testing.assert_array_equal(ps.model.fixed_flags, js.model.fixed_flags)
    np.testing.assert_array_equal(ps.model.picked_vert, js.model.picked_vert)
    np.testing.assert_array_equal(ps.model.mass, js.model.mass)
    assert ps.stats() == js.stats()
    assert ([c["vi"] for c in ps.model._positional]
            == [c["vi"] for c in js.model._positional])


def test_panel_and_handlers_match_jax(tmp_path):
    """Constraint toggles, side fixing, stepping, shift-click pins,
    ctrl-click drags and the reset, the same in both packages."""
    js, ps = sessions(tmp_path, vert_bending_constraint=False)
    assert_same(js, ps)
    project = lambda pos: pos[:, :2]  # noqa: E731
    events = [
        lambda s, h: s.set_constraint("vert_bending", True, wi=0.2),
        lambda s, h: s.set_constraint("edge", False),
        lambda s, h: s.set_sigma_range(0.95, 1.05),
        lambda s, h: s.fix_side("top"),
        lambda s, h: s.step(4),
        lambda s, h: h[0].handle_click(*s.model.positions[0, :2],
                                       shift=True),
        lambda s, h: s.step(2),
        lambda s, h: h[0].handle_click(*s.model.positions[10, :2],
                                       ctrl=True),
        lambda s, h: h[1].handle_move(s.model.positions[10, 0] + 2.0,
                                      s.model.positions[10, 1]),
        lambda s, h: s.step(3),
        lambda s, h: h[0].handle_release(),
        lambda s, h: h[0].handle_click(*s.model.positions[0, :2],
                                       shift=True),
        lambda s, h: s.release_side("top"),
        lambda s, h: s.set_gravity(False),
        lambda s, h: s.step(2),
    ]
    handlers = {id(s): s.mouse_handlers(project) for s in (js, ps)}
    for i, event in enumerate(events):
        for s in (js, ps):
            event(s, handlers[id(s)])
        assert_same(js, ps)
    assert ps.solver.frame == 11 and not ps.picking.is_picking
    assert ps.model.has_group("verts_bending")
    assert not ps.model.has_group("edge_spring")
    p0 = ps.model.init_positions.copy()
    js.reset()
    ps.reset()
    assert ps.solver.frame == 0
    np.testing.assert_allclose(ps.model.positions, p0)
    assert_same(js, ps)


def test_pre_draw_handler_and_capture_match_jax(tmp_path):
    """``PreDrawHandler`` stepping while animating (and not otherwise),
    with the headless capture writing a PNG every other frame."""
    from animsnapbases_tpu.sim.interaction import PreDrawHandler as JaxPre
    from animsnapbases_tpu_torch.sim.interaction import (
        PreDrawHandler,
        make_headless_capture,
        nearest_vertex_screen,
    )

    js, ps = sessions(tmp_path, vert_bending_constraint=False)
    js.fix_side("top")
    ps.fix_side("top")
    shots = str(tmp_path / "shots")
    hj = JaxPre(lambda: True, js.args, js.solver, js.fext)
    hp = PreDrawHandler(lambda: True, ps.args, ps.solver, ps.fext,
                        capture_fn=make_headless_capture(ps.model, shots,
                                                         every=2))
    for h in (hj, hp):
        h.handle()                   # not animating: no step
        h.set_animating(True)
        for _ in range(4):
            h.handle()
    assert ps.solver.frame == js.solver.frame == 4
    assert_same(js, ps)
    assert sorted(os.listdir(shots)) == ["frame_2.png", "frame_4.png"]
    pts = ps.model.positions
    assert nearest_vertex_screen(pts, lambda p: p[:, :2], *pts[7, :2]) == 7


def test_require_polyscope_raises_without_it(monkeypatch):
    from animsnapbases_tpu_torch.analysis import ps_viewer

    monkeypatch.setitem(sys.modules, "polyscope", None)
    with pytest.raises(RuntimeError, match="polyscope is not installed"):
        ps_viewer.require_polyscope()
    with pytest.raises(RuntimeError, match="polyscope is not installed"):
        ps_viewer.view_components_live("none.h5")


def _stub_polyscope(state, cb_holder, script):
    """polyscope and polyscope.imgui as module stubs whose ``show`` runs
    one callback a scripted frame."""
    io = types.SimpleNamespace(
        MouseClicked=[False], MouseDown=[False], MouseReleased=[False],
        MousePos=(0.0, 0.0), KeyShift=False, KeyCtrl=False)
    state["io"] = io

    def reset_io():
        io.MouseClicked[0] = io.MouseDown[0] = io.MouseReleased[0] = False
        io.KeyShift = io.KeyCtrl = False

    class FakeSurf:
        def update_vertex_positions(self, V):
            state["V"] = np.asarray(V)

        def add_scalar_quantity(self, *a, **k):
            pass

    class FakeCam:
        @staticmethod
        def get_view_mat():
            return np.eye(4)

        @staticmethod
        def get_projection_mat():
            return np.eye(4)

    def fake_show():
        for setup in script:
            reset_io()
            setup(state["session"])
            cb_holder["cb"]()

    ps_stub = types.ModuleType("polyscope")
    ps_stub.init = lambda: None
    ps_stub.set_up_dir = lambda *_: None
    ps_stub.register_surface_mesh = lambda *a, **k: FakeSurf()
    ps_stub.get_view_camera_parameters = lambda: FakeCam()
    ps_stub.get_window_size = lambda: (800, 600)
    ps_stub.set_user_callback = lambda cb: cb_holder.update(cb=cb)
    ps_stub.clear_user_callback = lambda: None
    ps_stub.show = fake_show
    psim_stub = types.ModuleType("polyscope.imgui")
    psim_stub.Checkbox = lambda label, v: (False, v)
    psim_stub.Button = lambda label: False
    psim_stub.SameLine = lambda: None
    psim_stub.TreeNode = lambda label: False
    psim_stub.TreePop = lambda: None
    psim_stub.BulletText = lambda *_: None
    psim_stub.GetIO = lambda: io
    ps_stub.imgui = psim_stub
    return ps_stub, psim_stub


def _view_script(state):
    """The scripted window events: a quiet frame, a shift-click pin, a
    ctrl-click pick, a drag and a release."""
    io = state["io"]

    def to_screen(p):
        return ((p[0] + 1) * 0.5 * 800.0, (1 - p[1]) * 0.5 * 600.0)

    def frame_quiet(sess):
        sess.set_gravity(False)

    def frame_shift_click(sess):
        state["fixed_before"] = int(sess.model.fixed_flags.sum())
        io.MouseClicked[0] = True
        io.KeyShift = True
        io.MousePos = to_screen(sess.model.positions[0])

    def frame_ctrl_click(sess):
        cand = int(np.flatnonzero(~sess.model.fixed_flags)[0])
        io.MouseClicked[0] = True
        io.KeyCtrl = True
        io.MousePos = to_screen(sess.model.positions[cand])

    def frame_drag(sess):
        v = sess.picking.picked_vertex
        state["dragged"] = v
        state["x_before"] = float(sess.model.positions[v, 0])
        io.MouseDown[0] = True
        x, y = to_screen(sess.model.positions[v])
        io.MousePos = (x + 40.0, y)

    def frame_release(sess):
        io.MouseReleased[0] = True

    return [frame_quiet, frame_shift_click, frame_ctrl_click, frame_drag,
            frame_release, lambda s: None, lambda s: None]


def _run_view(monkeypatch, module, cli_fn, config):
    state, cb_holder = {}, {}
    script = []
    ps_stub, psim_stub = _stub_polyscope(state, cb_holder, script)
    script.extend(_view_script(state))
    monkeypatch.setitem(sys.modules, "polyscope", ps_stub)
    monkeypatch.setitem(sys.modules, "polyscope.imgui", psim_stub)
    PV = module()
    orig = PV.show_session

    def capture_show(session, steps_per_frame=1):
        state["session"] = session
        orig(session, steps_per_frame=steps_per_frame)

    monkeypatch.setattr(PV, "show_session", capture_show)
    session = cli_fn(["--example", "interactive", "--cpu", "--config",
                      config])
    assert session is state["session"]
    return session, state, len(script)


def test_view_cli_launches_polyscope_app(monkeypatch, tmp_path):
    """``sim_cli --view`` with a stubbed polyscope builds the session and
    the viewer into one app; the scripted window events (shift-click pin,
    ctrl-click + drag force, release) act on the solver as the JAX app's
    do under the same events."""
    import animsnapbases_tpu.analysis.ps_viewer as JPV
    from animsnapbases_tpu.sim_cli import cli as jax_cli
    from animsnapbases_tpu_torch.analysis import ps_viewer
    from animsnapbases_tpu_torch.sim_cli import cli
    from test_torch_cli import small_config

    config = small_config(tmp_path)
    session, state, frames = _run_view(monkeypatch, lambda: ps_viewer, cli,
                                       config)
    assert session.solver.frame == frames
    assert int(session.model.fixed_flags.sum()) == state["fixed_before"] + 1
    assert any(c["vi"] == 0 for c in session.model._positional)
    v = state["dragged"]
    assert v >= 0
    assert float(session.model.positions[v, 0]) > state["x_before"]
    assert not session.picking.is_picking
    assert session.picking.picked_vertex == -1
    try:
        jsession, _, _ = _run_view(
            monkeypatch, lambda: importlib.reload(JPV), jax_cli, config)
        assert_same(jsession, session)
    finally:
        for m in ("polyscope", "polyscope.imgui"):
            sys.modules.pop(m, None)
        importlib.reload(JPV)
