"""Ensemble serving of the PyTorch port (``make_batched_run`` /
``make_batched_step``) and the batched builds of kernels 1, 2, 3 and 5,
float64 on the CPU (plain versions), against the JAX package.

Tolerances: P to 1e-6 and V to 1e-4 on the default route, as
``tests/test_resident_batched.py`` holds the JAX batched kernel; 1e-5 and
1e-3 on the large-model (chunked) route, as the JAX package holds its own.
The small scene is lifted 3 units (``test_torch_tiers``), so that gravity
leaves a contact-free window; 10x gravity slams a sim into the floor (40x,
the JAX test's slam, is chaotic in float64 with these bases: ROADMAP Queue
C).  Each sim gets its own gravity scale, so the trajectories part.
"""

import numpy as np
import pytest
import torch

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu_torch.ops.affine import (
    affine_run_plain,
    resident_affine_plain,
)
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked_plain
from animsnapbases_tpu_torch.ops.fused_reduced import (
    fused_reduced_iterations_batched,
    fused_reduced_iterations_plain,
)
from animsnapbases_tpu_torch.ops.resident import (
    force_term,
    predict,
    resident_multistep_batched,
    resident_multistep_plain,
)
from animsnapbases_tpu_torch.sim import reduced
from test_torch_fused_reduced import gravity, jax_solver, small_model
from test_torch_tiers import ITERS, _lifted, port_tiers

STEPS = 10
SLAM_STEPS = 20


def _args(tmp_path):
    return jax_solver(tmp_path, "off")[0].args


def jax_lifted(args, pallas_mode="off", **switches):
    """The JAX solver of the lifted small scene."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    model = _lifted(small_model(JaxModel, jax_cloth))
    s = JaxSolver(args, pallas_mode=pallas_mode)
    for k, v in switches.items():
        setattr(s, k, v)
    s.set_model(model)
    s.prepare(args)
    return s, model


def ensemble(model, scales):
    """(positions, velocities, fext) (B, N, 3): every sim at the model's
    state, sim b under ``scales[b]`` x gravity."""
    B = len(scales)
    pos = np.tile(model.positions, (B, 1, 1))
    f = np.stack([gravity(model) * s for s in scales])
    return pos, np.zeros_like(pos), f


def jax_step_loop(s, model, pos, vel, fs, steps):
    """Each sim's own JAX "off" step loop from (pos[b], vel[b]) ->
    (positions, velocities) (B, N, 3)."""
    out_p, out_v = [], []
    for p0, v0, f in zip(pos, vel, fs):
        model.positions, model.velocities = p0.copy(), v0.copy()
        s.frame = 0
        for _ in range(steps):
            s.step(f, num_iterations=ITERS)
        out_p.append(model.positions.copy())
        out_v.append(model.velocities.copy())
    return np.stack(out_p), np.stack(out_v)


def _close(p, v, ref, atol_p=1e-6, atol_v=1e-4):
    np.testing.assert_allclose(p, ref[0], rtol=0, atol=atol_p)
    np.testing.assert_allclose(v, ref[1], rtol=0, atol=atol_v)


def test_batched_run_matches_jax(tmp_path):
    """B = 3 at per-sim gravity scales over a contact-free window across two
    in-kernel rebases: the port's batched kernel 3 against the JAX
    ``make_batched_run`` on a ``pallas_mode="off"`` solver (its vmapped
    path) and against each sim's JAX step loop."""
    args = _args(tmp_path)
    s_j, m_j = jax_lifted(args)
    pos, vel, fs = ensemble(m_j, [1.0, 1.15, 1.3])
    p_j, v_j = (np.asarray(x) for x in s_j.make_batched_run()(
        pos, vel, fs, STEPS, num_iterations=ITERS))
    assert s_j._last_batched_path == "vmapped-xla"
    s, _ = port_tiers(args)
    p, v = s.make_batched_run()(pos, vel, fs, STEPS, num_iterations=ITERS)
    assert s._last_batched_path == "batched-resident"
    assert p.shape == pos.shape and np.isfinite(p).all()
    assert np.abs(p[2] - p[0]).max() > 1e-3       # the sims parted
    _close(p, v, (p_j, v_j))
    _close(p, v, jax_step_loop(s_j, m_j, pos, vel, fs, STEPS))
    assert s.frame == 0                           # the solver's own frame


def test_batched_run_matches_jax_interpret_kernel(tmp_path):
    """B = 2 against the JAX batched lean kernel in interpret mode
    (``build_resident_affine(nb=2, contact_mode=False)``), both with
    ``resident_rebase_every = 4``."""
    s_j, m_j = jax_solver(tmp_path, "interpret")
    s_j.resident_contact_mode = False
    s_j.resident_rebase_every = 4
    _lifted(m_j)
    s_j.set_dirty()
    s_j.prepare(s_j.args)
    pos, vel, fs = ensemble(m_j, [1.0, 1.2])
    p_j, v_j = (np.asarray(x) for x in s_j.make_batched_run()(
        pos, vel, fs, STEPS, num_iterations=ITERS))
    assert s_j._last_batched_path == "batched-resident"
    s, _ = port_tiers(s_j.args, resident_contact_mode=False)
    p, v = s.make_batched_run()(pos, vel, fs, STEPS, num_iterations=ITERS)
    assert s._last_batched_path == "batched-resident"
    _close(p, v, (p_j, v_j))


def test_batched_run_floor_contact(tmp_path):
    """One sim slammed into the floor at 10x gravity while the other stays
    airborne: the per-sim contact branch is exact for both."""
    args = _args(tmp_path)
    s_j, m_j = jax_lifted(args)
    pos, vel, fs = ensemble(m_j, [1.0, 10.0])
    s, _ = port_tiers(args)
    p, v = s.make_batched_run()(pos, vel, fs, SLAM_STEPS,
                                num_iterations=ITERS)
    ref = jax_step_loop(s_j, m_j, pos, vel, fs, SLAM_STEPS)
    assert ref[0][1, :, 1].min() < 0.05          # sim 1 reached the floor
    assert ref[0][0, :, 1].min() > 0.5           # sim 0 stayed airborne
    assert p[1, :, 1].min() > -0.5               # held at the floor
    _close(p, v, ref)


def test_batched_run_large_model_route(tmp_path):
    """``CHUNKED_TIER1_MIN_VERTS = 4`` puts the small scene on the
    large-model route with ``resident_rebase_every = 2``: batched kernel 5
    exits whole-batch when the slammed sim would clamp, a window runs on
    batched kernel 2, and stepping hands back; every sim matches its own JAX
    step loop."""
    args = _args(tmp_path)
    s_j, m_j = jax_lifted(args)
    pos, vel, fs = ensemble(m_j, [1.0, 10.0])
    s, _ = port_tiers(args, CHUNKED_TIER1_MIN_VERTS=4)
    s.resident_rebase_every = 2
    s.prepare(args)
    p, v = s.make_batched_run()(pos, vel, fs, SLAM_STEPS,
                                num_iterations=ITERS)
    assert s._last_batched_path.startswith("batched-chunked+perstep")
    _close(p, v, jax_step_loop(s_j, m_j, pos, vel, fs, SLAM_STEPS),
           atol_p=1e-5, atol_v=1e-3)


def test_batched_contact_mode_matches_jax_interpret_kernel(tmp_path):
    """The batched plain contact-mode build (``resident_affine_plain`` on
    (3, 3, N), ``rebase_every = 4``) over 12 steps of a mixed batch (sim 1
    under 4x gravity from 0.1 above the floor enters contact mode three
    times; sims 0 and 2 stay airborne) against ``build_resident_affine(
    nb=3, contact_mode=True, interpret=True)`` and against the solo plain
    version per sim.  The JAX kernel carries one mode flag for the batch,
    so its airborne sims take contact steps while sim 1 clamps; the port's
    never enter the mode.  P and V to 1e-9 against JAX (measured max |dP|
    5.0e-14, |dV| 8.8e-13 at |V| ~ 8; the JAX kernel at nb = 3 against its
    own nb = 1 runs 1.2e-12) and against the solo version.  (Sim 1 thrown
    down at 10x gravity, as in ``_mixed_batch``, crumples: there the JAX
    kernel at nb = 3 parts from its nb = 1 runs by 3e-9 in V.)"""
    from animsnapbases_tpu.ops.pallas_resident import build_resident_affine
    from test_torch_affine_chunked import jax_common

    s_j, _ = jax_solver(tmp_path, "interpret")
    st = s_j._resident_state
    B, steps, every = 3, 12, 4
    s, m = port_tiers(s_j.args)
    ao = s._affine
    pos, vel, fs = ensemble(m, [1.0, 4.0, 2.0])
    pos[1, :, 1] -= 2.9               # sim 1 starts 0.1 above the floor
    P, V, F, rb = _device_state(s, pos, vel, fs)
    run = build_resident_affine(
        *jax_common(s_j)[:-1], s_j.dt, True, m.floor_height, st["n_sel"],
        rebase_every=every, interpret=True, nb=B, contact_mode=True,
        eta=s_j.eta)

    def dim_major(x):                 # (B, 3, N) -> rows d * B + b
        return x.numpy().transpose(1, 0, 2).reshape(3 * B, -1)

    out_j = run(dim_major(P), dim_major(V), dim_major(F),
                np.zeros((1, 3 * B, rb.shape[1])), steps, ITERS)
    P_j, V_j = (np.asarray(x).reshape(3, B, -1).transpose(1, 0, 2)
                for x in out_j)
    ctx, state, flags = affine_run_plain(ao, P, V, F, rb, steps, ITERS,
                                         rebase_every=every,
                                         contact_mode=True)
    P_b, V_b = ctx.output(state)
    entries = (flags == 3).sum(1).tolist()
    assert entries[0] == entries[2] == 0 and entries[1] == 3
    np.testing.assert_allclose(P_b.numpy(), P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_b.numpy(), V_j, rtol=0, atol=1e-9)
    for b in range(B):
        P_s, V_s = resident_affine_plain(ao, P[b], V[b], F[b], rb, steps,
                                         ITERS, rebase_every=every,
                                         contact_mode=True)
        np.testing.assert_allclose(P_b[b].numpy(), P_s.numpy(), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(V_b[b].numpy(), V_s.numpy(), rtol=0,
                                   atol=1e-9)


def test_batched_run_contact_mode_matches_jax(tmp_path):
    """``make_batched_run`` with ``resident_contact_mode=True`` (the batched
    contact-mode kernel 3's plain version) against the JAX solver's with
    contact mode on in interpret mode (its batched contact-mode kernel),
    both with ``resident_rebase_every = 4``: B = 3 over the slam window,
    sim 1 at 10x gravity reaching the floor.  P and V to 1e-9 (measured
    max |dP| 2.5e-14, |dV| 8.2e-13 at |V| ~ 22)."""
    s_j, m_j = jax_solver(tmp_path, "interpret")
    s_j.resident_contact_mode = True
    s_j.resident_rebase_every = 4
    _lifted(m_j)
    s_j.set_dirty()
    s_j.prepare(s_j.args)
    pos, vel, fs = ensemble(m_j, [1.0, 10.0, 1.3])
    p_j, v_j = (np.asarray(x) for x in s_j.make_batched_run()(
        pos, vel, fs, SLAM_STEPS, num_iterations=ITERS))
    assert s_j._last_batched_path == "batched-resident"
    s, _ = port_tiers(s_j.args, resident_contact_mode=True)
    p, v = s.make_batched_run()(pos, vel, fs, SLAM_STEPS,
                                num_iterations=ITERS)
    assert s._last_batched_path == "batched-resident"
    assert p[1, :, 1].min() < 0.05 < p[0, :, 1].min()   # sim 1 at the floor
    _close(p, v, (p_j, v_j), atol_p=1e-9, atol_v=1e-9)


def _device_state(s, pos, vel, fs):
    return s._pack(pos), s._pack(vel), s._pack(fs), s._rb_extra()


def test_plain_kernel5_exits_whole_batch(tmp_path):
    """The batched plain kernel 5 stops for the whole batch at k = the
    minimum of the sims' own tier-1 k, and every sim is committed to
    exactly k steps (its state that of its own k-step run)."""
    s, m = port_tiers(_args(tmp_path))
    ao = s._affine
    P, V, F, rb = _device_state(s, *ensemble(m, [1.0, 10.0, 4.0]))
    solo = [affine_chunked_plain(ao, P[b], V[b], F[b], rb, SLAM_STEPS, ITERS,
                                 rebase_every=100) for b in range(3)]
    ks = [x[2] for x in solo]
    P_b, V_b, k = affine_chunked_plain(ao, P, V, F, rb, SLAM_STEPS, ITERS,
                                       rebase_every=100)
    assert ks[0] == SLAM_STEPS and 0 < min(ks) < max(ks)
    assert k == min(ks)
    for b in range(3):
        P_k, V_k, k_b = affine_chunked_plain(ao, P[b], V[b], F[b], rb, k,
                                             ITERS, rebase_every=100)
        assert k_b == k
        np.testing.assert_allclose(P_b[b].numpy(), P_k.numpy(), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(V_b[b].numpy(), V_k.numpy(), rtol=0,
                                   atol=1e-7)


def _solo_plain(kernel, ao, P, V, F, rb, b, steps):
    return {"k2": lambda: resident_multistep_plain(ao.res, P[b], V[b], F[b],
                                                   rb, steps, ITERS),
            "k3": lambda: resident_affine_plain(ao, P[b], V[b], F[b], rb,
                                                steps, ITERS, rebase_every=4),
            "k5": lambda: affine_chunked_plain(ao, P[b], V[b], F[b], rb,
                                               steps, ITERS, rebase_every=4)
            }[kernel]()


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k5"])
def test_batched_plain_matches_solo_plain(tmp_path, kernel):
    """Each batched plain version on the sim-major (B, 3, N) layout against
    the solo plain version from each sim's own state: the same function per
    sim, on a mixed batch (one sim reaching the floor, the others free).
    Kernel 3 branches per sim; kernel 5 exits for the whole batch, and each
    sim equals its own run of the batch's k steps."""
    s, m = port_tiers(_args(tmp_path), resident_contact_mode=False)
    ao, ro = s._affine, s._resident
    pos, vel, fs = ensemble(m, [1.0, 10.0, 2.0])
    pos[1, :, 1] -= 2.85                  # sim 1 starts just above the floor
    vel[1, :, 1] = -2.0
    P, V, F, rb = _device_state(s, pos, vel, fs)
    if kernel == "k1":
        sn, rbc = predict(ro, P, V, force_term(ro, F), rb)
        got = fused_reduced_iterations_batched(ro.fused, sn[..., :ro.n_sel],
                                               rbc, ITERS)
        for b in range(3):
            want = fused_reduced_iterations_plain(
                ro.fused, sn[b, :, :ro.n_sel], rbc[b], ITERS)
            np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=0,
                                       atol=1e-12)
        return
    steps = 6
    if kernel == "k2":
        out = resident_multistep_batched(ro, P, V, F, rb, steps, ITERS)
    elif kernel == "k3":
        out = s._run_batched_resident(P, V, F, rb, steps, ITERS)
    else:
        *out, steps = affine_chunked_plain(ao, P, V, F, rb, steps, ITERS,
                                           rebase_every=4)
        assert 0 < steps < 6
    for b in range(3):
        want = _solo_plain(kernel, ao, P, V, F, rb, b, steps)
        np.testing.assert_allclose(out[0][b].numpy(), want[0].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(out[1][b].numpy(), want[1].numpy(),
                                   rtol=0, atol=1e-7)


def _with_targets(model):
    model.add_positional_constraint(99, wi=1e4)
    return model


def test_batched_step_matches_jax_with_targets(tmp_path):
    """``make_batched_step`` (batched kernel 1's plain version) against the
    JAX ``make_batched_step`` on a ``pallas_mode="off"`` solver, three calls
    with per-call positional ``targets``."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    args = _args(tmp_path)
    m_j = _with_targets(_lifted(small_model(JaxModel, jax_cloth)))
    s_j = JaxSolver(args, pallas_mode="off")
    s_j.set_model(m_j)
    s_j.prepare(args)
    s, m = port_tiers(args)
    _with_targets(m)
    s.set_dirty()
    s.prepare(args)
    pos, vel, fs = ensemble(m_j, [1.0, 1.15, 1.3])
    step_j, step = s_j.make_batched_step(), s.make_batched_step()
    p_j, v_j, p, v = pos, vel, pos, vel
    for call in range(3):
        t = m_j.positional_targets(0) + np.array([0.0, 0.0, 0.1 * call])
        p_j, v_j = step_j(p_j, v_j, fs, num_iterations=ITERS, targets=t)
        p, v = step(p, v, fs, num_iterations=ITERS, targets=t)
    _close(p, v, (np.asarray(p_j), np.asarray(v_j)))


def test_one_sim_serves_on_the_solo_kernels(tmp_path, monkeypatch):
    """B = 1 serves on the solo wrappers on both routes (the default one in
    both builds of kernel 3) and in ``make_batched_step``; no batched
    wrapper is called."""
    def refuse(*a, **kw):
        raise AssertionError("a batched build served one sim")

    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    for name in ("resident_affine_batched", "affine_chunked_batched",
                 "resident_multistep_batched",
                 "fused_reduced_iterations_batched",
                 "resident_affine_contact_batched"):
        monkeypatch.setattr(reduced, name, refuse)
    for name in ("resident_affine", "affine_chunked", "resident_multistep",
                 "fused_reduced_iterations", "resident_affine_contact"):
        monkeypatch.setattr(reduced, name, spy(getattr(reduced, name)))
    args = _args(tmp_path)
    s_j, m_j = jax_lifted(args)
    pos, vel, fs = ensemble(m_j, [10.0])
    ref = jax_step_loop(s_j, m_j, pos, vel, fs, SLAM_STEPS)
    s, _ = port_tiers(args, resident_contact_mode=False)
    _close(*s.make_batched_run()(pos, vel, fs, SLAM_STEPS, ITERS), ref)
    assert set(calls) == {"resident_affine"}
    s.resident_contact_mode = True
    s.prepare(args)
    calls.clear()
    _close(*s.make_batched_run()(pos, vel, fs, SLAM_STEPS, ITERS), ref)
    assert set(calls) == {"resident_affine_contact"}
    s.CHUNKED_TIER1_MIN_VERTS = 4
    s.resident_rebase_every = 2
    s.prepare(args)
    calls.clear()
    p, v = s.make_batched_run()(pos, vel, fs, SLAM_STEPS, ITERS)
    assert s._last_batched_path.startswith("batched-chunked+perstep")
    assert set(calls) == {"affine_chunked", "resident_multistep"}
    _close(p, v, ref, atol_p=1e-5, atol_v=1e-3)
    calls.clear()
    s.make_batched_step()(pos, vel, fs, ITERS)
    assert calls == ["fused_reduced_iterations"]


def test_runner_serves_a_rebuild(tmp_path):
    """A runner made before ``set_dirty()`` + ``prepare()`` serves the
    rebuilt physics (cf. the JAX ``test_batched_run_fallback_tracks_
    rebuilds``): a static positional constraint added after creation."""
    args = _args(tmp_path)
    s, m = port_tiers(args)
    run = s.make_batched_run()
    _with_targets(m)
    s.set_dirty()
    s.prepare(args)
    s_j, m_j = jax_lifted(args)
    _with_targets(m_j)
    s_j.set_dirty()
    s_j.prepare(args)
    pos, vel, fs = ensemble(m_j, [1.0, 1.3])
    p, v = run(pos, vel, fs, STEPS, num_iterations=ITERS)
    _close(p, v, jax_step_loop(s_j, m_j, pos, vel, fs, STEPS))


def test_batched_serving_refuses(tmp_path):
    """Caller mistakes raise ``ValueError`` before any kernel runs (a
    ``targets_seq`` of the wrong shape or batch among them);
    self-collision raises ``RuntimeError`` but for ``make_batched_step``
    with the device pass captured at prepare, which applies it per sim;
    ``mesh=`` raises ``NotImplementedError`` naming its ROADMAP item; a
    configuration with a full group is served (batched-full)."""
    args = _args(tmp_path)
    s, m = port_tiers(args)
    pos, vel, fs = ensemble(m, [1.0, 1.0])
    run = s.make_batched_run()
    with pytest.raises(ValueError, match="batch mismatch"):
        run(pos, vel[:1], fs, 2)
    with pytest.raises(ValueError, match="must be"):
        run(pos[:, :-1], vel[:, :-1], fs[:, :-1], 2)
    with pytest.raises(ValueError, match="must be"):
        s.make_batched_step()(pos, vel, fs[:, :, :2])
    with pytest.raises(ValueError, match="targets_seq must be"):
        run(pos, vel, fs, 2, targets_seq=np.zeros((2, 1, 3)))
    with pytest.raises(ValueError, match="per-sim targets_seq has batch 3"):
        run(pos, vel, fs, 2, targets_seq=np.zeros((3, 2, 0, 3)))
    for make in (s.make_batched_run, s.make_batched_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make(mesh=object())
    s.enable_self_collision = True
    with pytest.raises(RuntimeError, match="self-collision"):
        run(pos, vel, fs, 2)
    with pytest.raises(RuntimeError, match="self-collision"):
        s.make_batched_run()
    with pytest.raises(RuntimeError, match="self-collision"):
        s.make_batched_step()(pos, vel, fs)
    s.enable_self_collision = "device"         # not captured at prepare
    with pytest.raises(RuntimeError, match="self-collision"):
        s.make_batched_step()(pos, vel, fs)
    s.set_dirty()
    s.prepare(args)                            # captured: served per sim
    p, v = s.make_batched_step()(pos, vel, fs)
    assert p.shape == pos.shape and np.isfinite(p).all()
    with pytest.raises(RuntimeError, match="self-collision"):
        run(pos, vel, fs, 2)
    s.enable_self_collision = False
    args.edge_spring_reduced = False           # a full (unreduced) group
    s2, m2 = port_tiers(args)
    p, _ = s2.make_batched_run()(*ensemble(m2, [1.0]), 2)
    assert s2._last_batched_path == "batched-full" and np.isfinite(p).all()


def test_pack_round_trip(tmp_path):
    """(B, N, 3) host arrays -> the permuted sim-major (B, 3, N) device
    layout -> back, exactly; entry (b, d, j) is vertex perm[j]'s dim d."""
    s, m = port_tiers(_args(tmp_path))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, m.n_verts, 3))
    packed = s._pack(x)
    assert tuple(packed.shape) == (4, 3, m.n_verts)
    assert packed.dtype == torch.float64
    perm = s._resident.perm
    np.testing.assert_array_equal(packed[2, 1].numpy(), x[2, perm, 1])
    np.testing.assert_array_equal(s._unpack(packed), x)


@pytest.mark.parametrize("case", ["bar_all", "bar_all_block"])
@pytest.mark.parametrize("route", ["contact_mode", "lean", "large_model"])
def test_batched_run_on_the_bar_matches_jax(tmp_path, case, route):
    """``make_batched_run`` at B = 3 on the tet bar of
    ``tests/test_torch_emitters.py`` (tets_strain, tets_deformation_gradient
    and verts_bending, row form and block form), sims at 1x, 4x and 10x
    gravity (the last slams into the floor), on the default route (batched
    kernel 3's contact-mode build), the lean build and the large-model route
    (batched kernels 5 and 2), against each sim's JAX ``pallas_mode="off"``
    step loop on the same bases.  Tolerances as above (P 1e-6, V 1e-4);
    measured at most 3.8e-14 in P and 2.2e-13 in V over the six cases."""
    from test_torch_emitters import solvers

    s, m, sj, mj = solvers(tmp_path, case, pallas_mode="off")
    s.resident_rebase_every = 4
    if route == "lean":
        s.resident_contact_mode = False
    if route == "large_model":
        s.CHUNKED_TIER1_MIN_VERTS = 4
    s.prepare(s.args)
    pos, vel, fs = ensemble(mj, [1.0, 4.0, 10.0])
    ref = jax_step_loop(sj, mj, pos, vel, fs, SLAM_STEPS)
    p, v = s.make_batched_run()(pos, vel, fs, SLAM_STEPS,
                                num_iterations=ITERS)
    assert s._last_batched_path.startswith(
        "batched-chunked" if route == "large_model" else "batched-resident")
    assert p[2][:, 1].min() < 0.05 and p[0][:, 1].min() > 0.5
    _close(p, v, ref)
