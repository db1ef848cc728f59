"""Animated positional targets on the PyTorch port (the per-step, per-sim
target-term schedule of kernels 2-5, ``run_steps`` on a poked model,
``make_batched_run(targets_seq=...)`` and ``run_steps(record=True)``)
against the JAX package, float64 on the CPU, on the small scene of
``tests/test_torch_fused_reduced.py`` with one ``user_defined`` poke on the
free vertex nearest its centroid.

Tolerances: the plain kernels against the JAX kernels in interpret mode to
1e-9, as the port's other kernel tests; the entry points to P 1e-6 and V
1e-4, as the port's tier tests and ``tests/test_resident_kernel.py`` hold
run_steps; each batched sim against its solo run to 1e-9.  Every window
crosses a rebase or chunk boundary (every 4 steps) and runs past the end of
its schedule.
"""

import numpy as np
import pytest
import torch

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu_torch.demos.poke import (
    create_poke_z_motion_with_jumps,
    voronoi_seeds_and_partition,
)
from animsnapbases_tpu_torch.ops.affine import (
    resident_affine_exit_plain,
    resident_affine_plain,
)
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked_plain
from animsnapbases_tpu_torch.ops.resident import resident_multistep_plain
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.solver import positional_targets_timeline
from test_torch_affine_chunked import (
    jax_common,
    lean_jax_solver,
    packed_state,
    port_affine,
)
from test_torch_batched import ensemble
from test_torch_fused_reduced import gravity, jax_solver, small_model
from test_torch_tiers import _lifted, spy_tier1

ITERS = 6
REBASE = 4
POKE_WI = 1e5
SCHED_ROWS = 7      # the kernels' schedules: shorter than their windows


def poke_shift(amp=0.3, f_l=8, f_j=2, k=2):
    """A poke's z-motion: ``k`` cycles of ``f_l`` frames and ``f_j``
    paused frames, ``amp`` deep."""
    return create_poke_z_motion_with_jumps(f_l, f_j, k, z_range=amp)


def poke_vertex(model):
    """The free vertex nearest the centroid (scripts/bench_poke.py)."""
    d = np.linalg.norm(model.positions - model.positions.mean(axis=0),
                       axis=1)
    d[model.fixed_flags] = np.inf
    return int(np.argmin(d))


def add_poke(model, shift):
    """The poke at ``poke_vertex``: animated by ``shift``, or held fixed at
    its rest position when ``shift`` is None."""
    if shift is None:
        model.add_positional_constraint(poke_vertex(model), wi=POKE_WI)
    else:
        model.add_positional_constraint(poke_vertex(model), wi=POKE_WI,
                                        motion_type="user_defined",
                                        frame_shift=shift)
    return model


def test_timeline_schedule_and_poke_match_jax(tmp_path):
    """``create_poke_z_motion_with_jumps`` and ``voronoi_seeds_and_
    partition`` equal the JAX package's bit for bit; the port's
    ``positional_targets_timeline`` equals the JAX one's rows (the JAX one
    pads to a power of two with its last row) at the start, mid-schedule,
    at its last frame and past it; the solver's prepared (T, 3, r) schedule
    equals the JAX solver's ``_rb_window_host(0, T)`` to 1e-12 of its
    largest entry (the same float64 sums in another order)."""
    from animsnapbases_tpu.demos import poke as jax_poke
    from animsnapbases_tpu.sim.solver import (
        positional_targets_timeline as jax_timeline,
    )

    for args in ((40, 8, 3, 0.05), (9, 0, 2, 1.0), (5, 3, 1, 0.3)):
        np.testing.assert_array_equal(
            create_poke_z_motion_with_jumps(*args),
            jax_poke.create_poke_z_motion_with_jumps(*args))
    V, F = jax_cloth(12, 9)
    for k in (0, 3):
        for mine, ref in zip(voronoi_seeds_and_partition(V, F, k),
                             jax_poke.voronoi_seeds_and_partition(V, F, k)):
            np.testing.assert_array_equal(mine, ref)

    shift = poke_shift()
    models = [add_poke(small_model(JaxModel, jax_cloth), shift),
              add_poke(small_model(DeformableModel), shift)]
    models[1].add_positional_constraint(3, wi=1e4)      # a static one
    models[0].add_positional_constraint(3, wi=1e4)
    n = len(shift)
    for frame, steps in ((0, 64), (5, 4), (n - 1, 8), (n + 3, 8)):
        tl, animated = positional_targets_timeline(models[1], frame, steps)
        tl_j, animated_j = jax_timeline(models[0], frame, steps)
        assert animated == animated_j == (frame < n)
        assert len(tl) == (min(steps, n - frame) if animated else 1)
        np.testing.assert_array_equal(tl, tl_j[:len(tl)])
        np.testing.assert_array_equal(tl_j[len(tl):],
                                      np.repeat(tl[-1:], len(tl_j) - len(tl),
                                                axis=0))

    s_j, _ = jax_solver(tmp_path, "interpret")
    add_poke(s_j.model, shift).add_positional_constraint(3, wi=1e4)
    s_j.set_dirty()
    s_j.prepare(s_j.args)
    from test_torch_fused_reduced import port_solver

    s, m = port_solver(s_j.args)
    add_poke(m, shift).add_positional_constraint(3, wi=1e4)
    s.set_dirty()
    s.prepare(s.args)
    ref = s_j._rb_window_host(0, n)
    sched = s._rb_sched.numpy()
    assert sched.shape == ref.shape == (n, 3, s.U.shape[1])
    np.testing.assert_allclose(sched, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # a call past the schedule's end is static: its targets' term
    past = s._rb_schedule_from(n + 2)
    assert past.shape == (3, s.U.shape[1])
    np.testing.assert_allclose(past.numpy(), ref[-1], rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_schedule_layout_and_checks(tmp_path):
    """What the kernels are handed: ``rb_at`` takes row min(i, T - 1),
    ``rb_from`` the schedule from a step on (a view), ``rb_layout`` its rows
    and sim stride (0 when shared, T*3r per sim, kept by a view from a later
    step); the wrappers' ``check_state`` takes (3, r), (T, 3, r) and, for a
    batch of B sims, (B, T, 3, r) with contiguous (3, r) rows, and raises on
    anything else."""
    from animsnapbases_tpu_torch.ops.resident import (
        check_state,
        rb_at,
        rb_from,
        rb_layout,
    )

    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model, dtype=torch.float32)
    ro, r = ao.res, ao.fused.r
    P = torch.zeros(3, ro.n)
    Pb = torch.zeros(2, 3, ro.n)
    sched = torch.arange(2 * 5 * 3 * r, dtype=torch.float32).reshape(
        2, 5, 3, r)
    assert torch.equal(rb_at(sched, 3), sched[:, 3])
    assert torch.equal(rb_at(sched, 9), sched[:, 4])
    assert torch.equal(rb_at(sched[0, 0], 9), sched[0, 0])
    later = rb_from(sched, 2)
    assert torch.equal(rb_at(later, 1), sched[:, 3])
    assert torch.equal(rb_from(sched, 7)[:, 0], sched[:, 4])
    assert rb_layout(sched[0, 0]) == (1, 0)
    assert rb_layout(sched[0]) == (5, 0)
    assert rb_layout(later) == (3, 5 * 3 * r)
    assert later.data_ptr() == sched.data_ptr() + 2 * 3 * r * 4
    for state, rb in ((P, sched[0, 0]), (P, sched[0]), (Pb, sched[0]),
                      (Pb, later), (Pb, sched[:, :1])):
        check_state(ro, state, state, state, rb)
    for state, rb in ((P, sched), (Pb, sched[:1]), (P, sched[0, :0]),
                      (P, sched[0, :, :, :-1]), (P, sched[0, :, :2])):
        with pytest.raises(ValueError, match="rb_extra must be"):
            check_state(ro, state, state, state, rb)
    with pytest.raises(ValueError, match="contiguous"):
        check_state(ro, P, P, P, torch.zeros(5, r, 3).transpose(1, 2))
    with pytest.raises(TypeError):
        check_state(ro, P, P, P, sched[0].double())


# ---------------------------------------------------------------------------
# the plain kernels against the JAX kernels, T > 1
# ---------------------------------------------------------------------------

# each kernel's (steps, sims' (lift, gravity scale)): kernels 4 and 5 on a
# contact-free window (tier 1 serves it whole), kernels 2 and 3 on one that
# reaches the floor from 0.1 above it under 4x gravity (an airborne sim
# beside it at nb = 3)
KERNEL_WINDOWS = {
    "2": (10, [(0.1, 4.0), (3.0, 1.0), (0.1, 2.0)]),
    "3": (10, [(0.1, 4.0), (3.0, 1.0), (0.1, 2.0)]),
    "3c": (10, [(0.1, 4.0), (3.0, 1.0), (0.1, 2.0)]),
    "4": (10, [(3.0, 1.0)]),
    "5": (10, [(3.0, 1.0), (3.0, 1.5), (3.0, 2.0)]),
}
KERNEL_CASES = [(k, nb) for k in KERNEL_WINDOWS for nb in (1, 3)
                if nb <= len(KERNEL_WINDOWS[k][1])]


def _jax_kernel(s, model, kernel, nb):
    """The JAX kernel ``kernel`` at ``nb`` sims, interpret mode, rebases
    (kernel 5: chunks) every REBASE steps."""
    from animsnapbases_tpu.ops import pallas_resident as pr

    st = s._resident_state
    ops = st["ops"]
    common = jax_common(s)
    if kernel == "2":
        return pr.build_resident_multistep(
            ops, ops["gather_slices"], ops["layout"], ops["G_allT"],
            ops["WT_all"], ops["inv3"], st["U_liftT"], st["ut_acT"],
            st["mass_inv"], s.dt, True, model.floor_height, st["n_sel"],
            interpret=True, eta=s.eta, nb=nb)
    if kernel in ("3", "3c"):
        return pr.build_resident_affine(
            *common[:-1], s.dt, True, model.floor_height, st["n_sel"],
            rebase_every=REBASE, interpret=True, nb=nb,
            contact_mode=kernel == "3c", eta=s.eta)
    if kernel == "4":
        return pr.build_resident_affine_exit(
            *common, model.floor_height, st["n_sel"], rebase_every=REBASE,
            interpret=True, eta=s.eta)
    return pr.build_resident_affine_chunked(
        *common, model.floor_height, st["n_sel"], rebase_every=REBASE,
        interpret=True, eta=s.eta, nb=nb)


def _plain_kernel(ao, kernel, P, V, F, rb, steps):
    """The port's plain version of ``kernel`` -> (P', V')."""
    if kernel == "2":
        return resident_multistep_plain(ao.res, P, V, F, rb, steps, ITERS)
    if kernel in ("3", "3c"):
        return resident_affine_plain(ao, P, V, F, rb, steps, ITERS,
                                     rebase_every=REBASE,
                                     contact_mode=kernel == "3c")
    if kernel == "4":
        out = resident_affine_exit_plain(ao, P, V, F, rb, steps, ITERS,
                                         rebase_every=REBASE)
    else:
        out = affine_chunked_plain(ao, P, V, F, rb, steps, ITERS,
                                   rebase_every=REBASE)
    assert out[2] == steps                   # tier 1 served the window
    return out[:2]


@pytest.mark.parametrize("kernel,nb", KERNEL_CASES)
def test_plain_kernels_follow_the_schedule_like_jax(tmp_path, kernel, nb):
    """Kernels 2, 3 (lean), 3' (contact mode), 4 and 5 with a SCHED_ROWS-row
    target-term schedule over a longer window (past its end, across
    rebases or chunks every REBASE steps): the plain version against the
    JAX kernel in interpret mode, one schedule at nb = 1 and a schedule per
    sim at nb = 3 (poke amplitude and phase per sim), P and V to 1e-9; at
    nb = 3 each sim also against the solo plain version from its own
    schedule (1e-9).  The schedule must matter: its first row alone moves
    the result by more than 1e-6."""
    steps, sims = KERNEL_WINDOWS[kernel]
    sims = sims[:nb]
    s, model = lean_jax_solver(tmp_path)
    add_poke(model, poke_shift())
    s.set_dirty()
    s.prepare(s.args)
    st = s._resident_state
    utst = np.asarray(s._resident_utst)                  # (3, r, e)
    p0 = model.groups["positional"].data["p0"]
    rb = []                                              # (B, T, 3, r)
    for b in range(nb):
        sh = np.roll(poke_shift(amp=0.3 - 0.2 * b), 2 * b,
                     axis=0)[:SCHED_ROWS]
        rb.append(np.einsum("dre,ted->tdr", utst, p0[None] + sh[:, None]))
    rb = np.stack(rb)
    states = [packed_state(s, model, lift, scale) for lift, scale in sims]
    P, V, F = (np.stack(x) for x in zip(*states))        # (B, 3, N)

    def dim_major(x):                                    # rows d * B + b
        return np.ascontiguousarray(x.transpose(1, 0, 2).reshape(
            3 * nb, *x.shape[2:]))

    run = _jax_kernel(s, model, kernel, nb)
    rb_j = np.ascontiguousarray(rb.transpose(1, 2, 0, 3)).reshape(
        SCHED_ROWS, 3 * nb, -1)
    out_j = run(dim_major(P), dim_major(V), dim_major(F), rb_j, steps, ITERS)
    if kernel in ("4", "5"):
        assert int(np.asarray(out_j[2])[0, 0]) == steps
    P_j, V_j = (np.asarray(x).reshape(3, nb, -1).transpose(1, 0, 2)
                for x in out_j[:2])

    ao = port_affine(s, model)
    Pt, Vt, Ft = (torch.from_numpy(x) for x in (P, V, F))
    rbt = torch.from_numpy(rb)
    if nb == 1:
        Pt, Vt, Ft, rbt = Pt[0], Vt[0], Ft[0], rbt[0]
    P_t, V_t = _plain_kernel(ao, kernel, Pt, Vt, Ft, rbt, steps)
    P_t, V_t = (x.reshape(nb, 3, -1).numpy() for x in (P_t, V_t))
    np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_t, V_j, rtol=0, atol=1e-9)
    if nb > 1:
        for b in range(nb):
            P_s, V_s = _plain_kernel(ao, kernel, Pt[b], Vt[b], Ft[b],
                                     rbt[b], steps)
            np.testing.assert_allclose(P_t[b], P_s.numpy(), rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(V_t[b], V_s.numpy(), rtol=0,
                                       atol=1e-9)
    P_0, _ = _plain_kernel(ao, kernel, Pt, Vt, Ft, rbt[..., 0, :, :], steps)
    assert np.abs(P_0.reshape(nb, 3, -1).numpy() - P_t).max() > 1e-6


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _poked_pair(tmp_path, shift, **switches):
    """(JAX interpret-mode solver, its model, the port's solver, its model)
    of the lifted small scene with the poke, ``resident_rebase_every =
    REBASE`` and ``switches`` on both."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    args = jax_solver(tmp_path, "off")[0].args
    out = []
    for cls, model in ((JaxSolver, _lifted(small_model(JaxModel, jax_cloth))),
                       (AnimSnapBasesSolver,
                        _lifted(small_model(DeformableModel)))):
        add_poke(model, shift)
        s = (cls(args, pallas_mode="interpret") if cls is JaxSolver
             else cls(args, device="cpu"))
        s.resident_rebase_every = REBASE
        for k, v in switches.items():
            setattr(s, k, v)
        s.set_model(model)
        s.prepare(args)
        out += [s, model]
    return out


def _port_step_loop(args, shift, windows, **switches):
    """The port's step() loop over ``windows`` [(force scale, steps)] of
    the lifted, poked small scene -> its model."""
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    model = add_poke(_lifted(small_model(DeformableModel)), shift)
    s = AnimSnapBasesSolver(args, device="cpu")
    s.set_model(model)
    s.prepare(args)
    f = gravity(model)
    for scale, steps in windows:
        for _ in range(steps):
            s.step(f * scale, num_iterations=ITERS)
    return model


def _close(model, ref, atol_p=1e-6, atol_v=1e-4):
    np.testing.assert_allclose(model.positions, ref.positions, rtol=0,
                               atol=atol_p)
    np.testing.assert_allclose(model.velocities, ref.velocities, rtol=0,
                               atol=atol_v)


# the tier switches of run_steps' cases, and the (tier 1, contact tier)
TIERS = {
    "default": {},
    "exit": {"resident_chunked_tier1": False,
             "resident_contact_mode": False},
    "standard": {"CHUNKED_TIER1_MIN_VERTS": 4},
}


@pytest.mark.parametrize("tiers", list(TIERS))
def test_run_steps_poked_matches_jax(tmp_path, tiers):
    """``run_steps`` on the poked scene (a 20-frame schedule) against the
    JAX ``run_steps`` in interpret mode with the same switches and against
    the port's step() loop: a contact-free window of 12 steps at 1x
    gravity that tier 1 serves whole and certifies, then 3 calls of 6
    steps at 10x gravity in which tier 1 exits mid-schedule and the
    contact tier continues from the frame it stopped at, past the
    schedule's end (frame 30).  Default tiers: kernel 5, then kernel 3's
    contact-mode build; ``exit``: kernel 4, then kernel 3 lean;
    ``standard``: kernel 5, then kernel 2.  P to 1e-6, V to 1e-4."""
    shift = poke_shift()
    s_j, m_j, s, m = _poked_pair(tmp_path, shift, **TIERS[tiers])
    f = gravity(m)
    fast = spy_tier1(s)
    s.run_steps(f, 12, num_iterations=ITERS)
    s_j.run_steps(f, 12, num_iterations=ITERS)
    assert s._last_fast_steps == 12 and fast == [12]
    for _ in range(3):
        s.run_steps(10 * f, 6, num_iterations=ITERS)
        s_j.run_steps(10 * f, 6, num_iterations=ITERS)
    assert s.frame == s_j.frame == 30 > len(shift)
    assert any(0 < k < 6 for k in fast[1:])          # a tier-1 exit
    assert m.positions[:, 1].min() < 0.05             # at the floor
    _close(m, m_j)
    _close(m, _port_step_loop(s.args, shift, [(1.0, 12), (10.0, 18)]))


def test_run_steps_poked_matches_step_loop_in_short_calls(tmp_path):
    """``run_steps`` in calls of 5 steps over a 20-frame schedule and 10
    frames past it (tier 1 throughout) equals the port's step() loop to
    1e-9: each call continues the schedule at its own frame."""
    shift = poke_shift()
    *_, s, m = _poked_pair(tmp_path, shift)
    f = gravity(m)
    for _ in range(6):
        s.run_steps(f, 5, num_iterations=ITERS)
        assert s._last_fast_steps == 5
    _close(m, _port_step_loop(s.args, shift, [(1.0, 30)]), 1e-9, 1e-9)


def _per_sim_shifts(B):
    return [np.roll(poke_shift(amp=0.3 - 0.15 * b), 3 * b, axis=0)
            for b in range(B)]


def _solo_poked(args, shift, pos, vel, f, steps, **switches):
    """The port's solo run_steps of one sim with its own poke ``shift``
    from (pos, vel) -> its model."""
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    model = add_poke(_lifted(small_model(DeformableModel)), shift)
    model.positions, model.velocities = pos.copy(), vel.copy()
    s = AnimSnapBasesSolver(args, device="cpu")
    s.resident_rebase_every = REBASE
    for k, v in switches.items():
        setattr(s, k, v)
    s.set_model(model)
    s.prepare(args)
    s.run_steps(f, steps, num_iterations=ITERS)
    return model


@pytest.mark.parametrize("route", ["contact_mode", "lean", "large_model"])
def test_batched_run_per_sim_timelines(tmp_path, route):
    """``make_batched_run`` at B = 3 with a per-sim (B, T, e, 3) timeline
    (each sim's own poke, amplitude and phase) over 24 steps of a 20-frame
    timeline, the last sim slammed at 10x gravity: each sim against its own
    poked solo ``run_steps`` (P 1e-6, V 1e-4), on the default route
    (batched kernel 3's contact-mode build), the lean build and the
    large-model route (batched kernels 5 and 2, each window from its own
    offset of the timeline)."""
    switches = {"contact_mode": {}, "lean": {"resident_contact_mode": False},
                "large_model": {"CHUNKED_TIER1_MIN_VERTS": 4}}[route]
    shifts = _per_sim_shifts(3)
    *_, s, m = _poked_pair(tmp_path, shifts[0], **switches)
    tls = np.stack([positional_targets_timeline(
        add_poke(_lifted(small_model(DeformableModel)), sh), 0, 64)[0]
        for sh in shifts])
    pos, vel, fs = ensemble(m, [1.0, 1.3, 10.0])
    p, v = s.make_batched_run()(pos, vel, fs, 24, num_iterations=ITERS,
                                targets_seq=tls)
    assert s._last_batched_path.startswith(
        "batched-chunked" if route == "large_model" else "batched-resident")
    assert p[2][:, 1].min() < 0.05 < p[0][:, 1].min()
    for b in range(3):
        ref = _solo_poked(s.args, shifts[b], pos[b], vel[b], fs[b], 24,
                          **switches)
        np.testing.assert_allclose(p[b], ref.positions, rtol=0, atol=1e-6)
        np.testing.assert_allclose(v[b], ref.velocities, rtol=0, atol=1e-4)


def test_batched_run_shared_timeline_matches_jax(tmp_path):
    """A shared (T, e, 3) timeline (the poke at double amplitude, 20
    frames) at B = 2 over 24 steps: the port's ``make_batched_run`` against
    the JAX one in interpret mode (P 1e-6, V 1e-4), and B = 1 (the solo
    kernels) against sim 0."""
    shift = poke_shift()
    s_j, m_j, s, m = _poked_pair(tmp_path, shift)
    tl = positional_targets_timeline(
        add_poke(_lifted(small_model(DeformableModel)), 2 * shift), 0,
        64)[0]
    pos, vel, fs = ensemble(m, [1.0, 1.5])
    p, v = s.make_batched_run()(pos, vel, fs, 24, num_iterations=ITERS,
                                targets_seq=tl)
    p_j, v_j = (np.asarray(x) for x in s_j.make_batched_run()(
        pos, vel, fs, 24, num_iterations=ITERS, targets_seq=tl))
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-4)
    p1, v1 = s.make_batched_run()(pos[:1], vel[:1], fs[:1], 24,
                                  num_iterations=ITERS, targets_seq=tl)
    np.testing.assert_allclose(p1[0], p[0], rtol=0, atol=1e-9)
    assert np.abs(p - s.make_batched_run()(
        pos, vel, fs, 24, num_iterations=ITERS)[0]).max() > 1e-6


def test_batched_run_default_timeline_continues(tmp_path):
    """Without ``targets_seq`` the sims follow the model's own schedule
    from the serving frame: two calls of 12 steps (the second past the
    schedule's end) equal one solo ``run_steps`` of 24 from the same
    state (1e-9), and differ from replaying the first window."""
    shift = poke_shift()
    *_, s, m = _poked_pair(tmp_path, shift)
    pos, vel, fs = ensemble(m, [1.0, 1.2])
    run = s.make_batched_run()
    p, v = run(pos, vel, fs, 12, num_iterations=ITERS)
    p, v = run(p, v, fs, 12, num_iterations=ITERS)
    assert s.frame == 0
    for b in range(2):
        ref = _solo_poked(s.args, shift, pos[b], vel[b], fs[b], 24)
        np.testing.assert_allclose(p[b], ref.positions, rtol=0, atol=1e-9)
        np.testing.assert_allclose(v[b], ref.velocities, rtol=0, atol=1e-9)
    replay = s.make_batched_run()
    q, w = replay(pos, vel, fs, 12, num_iterations=ITERS)
    q, _ = replay(q, w, fs, 12, num_iterations=ITERS, targets_seq=np.repeat(
        s.model.positional_targets(0)[None], 12, axis=0))
    assert np.abs(q - p).max() > 1e-6


@pytest.mark.parametrize("animated", [False, True])
def test_recorded_run_matches_jax(tmp_path, animated):
    """``run_steps(record=True)`` over 24 steps (past the 20-frame
    schedule when animated) against the JAX ``run_steps(record=True)``
    (``_run_steps_recorded``) in interpret mode: the (24, N, 3)
    trajectory, the end state and ``positions_corrections`` to P 1e-6, V
    1e-4; the end state equals the port's step() loop to 1e-12 (the same
    kernel-1 steps).  The scene starts 0.1 above the floor under 4x
    gravity, so the floor clamps; without animation the poke holds its
    vertex fixed."""
    shift = poke_shift() if animated else None
    s_j, m_j, s, m = _poked_pair(tmp_path, shift)
    for model in (m_j, m):
        model.positions[:, 1] -= 2.9
    f = 4 * gravity(m)
    traj = s.run_steps(f, 24, num_iterations=ITERS, record=True)
    traj_j = np.asarray(s_j.run_steps(f, 24, num_iterations=ITERS,
                                      record=True))
    assert traj.shape == traj_j.shape == (24, m.n_verts, 3)
    assert s.frame == 24 and s._last_fast_steps is None
    np.testing.assert_allclose(traj, traj_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(traj[-1], m.positions)
    _close(m, m_j)
    assert m.positions_corrections[:, 1].min() < 0
    np.testing.assert_allclose(m.positions_corrections,
                               m_j.positions_corrections, rtol=0, atol=1e-6)
    ref = add_poke(_lifted(small_model(DeformableModel)), shift)
    ref.positions[:, 1] -= 2.9
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    s_ref = AnimSnapBasesSolver(s.args, device="cpu")
    s_ref.set_model(ref)
    s_ref.prepare(s.args)
    for _ in range(24):
        s_ref.step(f, num_iterations=ITERS)
    np.testing.assert_allclose(m.positions, ref.positions, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(m.positions_corrections,
                               ref.positions_corrections, rtol=0, atol=1e-12)
