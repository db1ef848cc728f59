"""The port's smoke battery on the card: ``python -m
animsnapbases_tpu_torch.smoke [check ...]``.

Counterpart of ``scripts/smoke_tpu.py``: the same nine checks, each on a
small model with the synthetic bases of ``utils/synthetic.py`` in float32
on the card, driven through the entry points a user calls, its kernels
counted (the path's own kernels must launch) and held against their plain
versions with ``holds.py``'s rules (``chip_smoke.py``'s): one-step calls
at ``STEP_TOL`` of each step's size, the steps a call carries
(``carried_steps``), kernel 1 against float64 (``as_accurate``), each
batched sim of kernel 3 bit for bit against its solo kernel, and of kernel
5's whole call (its outer loop's float64 anchors summed over the batch)
within 4 float32 units.  It prints one ``PASS
<name> (<s>)`` line a check, exits non-zero at the first failure, refuses
unknown names, and refuses to run without a card (a CPU run would hold no
kernel).

  contact          the floor-contact handoff: tier 1 (kernel 5) to the
                   contact tier (kernel 3, contact mode)
  tets             tets_strain + tets_deformation_gradient (kernels 1, 5)
  bend             verts_bending (kernels 1, 5)
  batched          make_batched_run, one sim slamming the floor (batched
                   kernel 3, contact mode)
  batched_poke     per-sim animated schedules (batched kernel 3)
  damped           the damped predictor: contact mode, then the lean
                   build's tier-1 exit kernel (kernel 4)
  chunked          the large-model tiers forced on a small cloth: kernel 5,
                   then kernel 2 past a floor hit
  chunked_only     the same route at CHUNKED_TIER1_MIN_VERTS vertices, where
                   the solver takes it by itself (the JAX check's VMEM gate
                   has no counterpart here)
  batched_chunked  make_batched_run on the large-model route: batched
                   kernel 5, then windows on batched kernel 2
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from animsnapbases_tpu_torch import holds

ITERATIONS = 10
# one-step calls held against the plain version from each check's state
HOLD_STEPS = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def counters():
    """Every kernel wrapper's launch counter, solo and batched, and those
    of kernel 5's other builds (``ops/affine_chunked.py`` ``COUNTERS``)."""
    from animsnapbases_tpu_torch.ops import (
        affine,
        affine_chunked,
        fused_reduced,
        resident,
    )

    return (fused_reduced.fused_reduced_iterations, resident.resident_multistep,
            affine.resident_affine, affine.resident_affine_exit,
            affine_chunked.affine_chunked, affine.resident_affine_contact,
            fused_reduced.fused_reduced_iterations_batched,
            resident.resident_multistep_batched,
            affine.resident_affine_batched,
            affine_chunked.affine_chunked_batched,
            affine.resident_affine_contact_batched,
            affine.resident_affine_exit_batched, *affine_chunked.COUNTERS)


def kernel5(solver, batched=False) -> str:
    """The counter name of the solver's build of kernel 5 (the exact-free
    build at ``CHUNKED_EXACT_FREE_MIN_VERTS`` vertices and above)."""
    from animsnapbases_tpu_torch.ops.affine_chunked import counter

    return counter(solver._chunk_opts, batched).__name__


def counted(label, run, must, may=()):
    """``run()`` with every counter set to 0 before it: each kernel of
    ``must`` launched, none but those of ``must`` and ``may``."""
    fns = counters()
    for fn in fns:
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in fns}
    for name, n in counts.items():
        if name in must:
            holds.require(n > 0, f"{label}: {name} was never launched")
        elif name not in may:
            holds.require(n == 0, f"{label}: {name} launched {n} times "
                          "off its path")
    log(f"[smoke] {label}: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out


def cloth(rows=8, cols=8, bending=False):
    """The JAX battery's cloth: sheared, floor on, 3 units up, the left
    side pinned."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, F = cloth_model(rows, cols)
    V = V.copy()
    V[:, 2] += 0.1 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=3.0)
    if bending:
        model.add_vertex_bending_constraint(1e4)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


def solver_of(model, dev, **extra):
    """The fully reduced solver of ``model`` on synthetic bases, float32
    state and matrices on ``dev``; ``extra`` sim-arg overrides."""
    from animsnapbases_tpu_torch.device import working_dtype
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    return synthetic_reduced_solver(model, device=dev,
                                    dtype=working_dtype(dev, torch.float32),
                                    extra_args=extra or None)


def gravity(model, scale=1.0):
    f = np.zeros_like(model.positions)
    f[:, 1] = -98.1 * scale
    return f


def state(solver, model, f):
    """The model's state and ``f`` as permuted (3, N) tensors."""
    return (solver._to_device(model.positions),
            solver._to_device(model.velocities), solver._to_device(f))


def hold_kernel1(solver, P, V, Fx):
    """Kernel 1's loop from the predictor of (P, V) against float64
    (``as_accurate``)."""
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, predict

    ro = solver._resident
    sn, rb_const = predict(ro, P, V, force_term(ro, Fx), solver._rb_extra())
    sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(ro.fused, sel, rb_const, ITERATIONS)
    u_p = fused_reduced_iterations_plain(ro.fused, sel, rb_const, ITERATIONS)
    u_64 = fused_reduced_iterations_plain(
        holds.as_f64(ro.fused), sel.double(), rb_const.double(), ITERATIONS)
    ok, e_k, e_p = holds.as_accurate(u_k, u_p, u_64)
    holds.require(ok and bool(torch.isfinite(u_k).all()),
                  f"kernel 1 off float64 by {e_k:.3e}, its plain version "
                  f"by {e_p:.3e}")


def hold_one_step(label, solver, kernel, plain, P, V, Fx, **kw):
    """HOLD_STEPS one-step calls of ``kernel`` against ``plain`` from (P,
    V), each from the kernel's own state (``step_by_step``)."""
    ao = solver._affine
    operands = ao.res if kernel.__name__.startswith("resident_multistep") \
        else ao
    rb = solver._rb_extra()

    def one(fn):
        def run(P_, V_):
            return fn(operands, P_, V_, Fx, rb, 1, ITERATIONS, **kw)[:2]
        return run

    holds.step_by_step(torch, label, solver._resident, one(kernel),
                       one(plain), P, V, Fx, rb, HOLD_STEPS)


def carried_kernel5(label, solver, P, V, Fx):
    """The steps one call of kernel 5 carries (``carried_steps``) from
    (P, V), in the solver's build and chunk."""
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked_plain,
    )

    every = solver._chunk_every
    holds.carried_steps(
        torch, f"{label}: kernel 5", 5, solver._affine,
        lambda *a: affine_chunked_plain(*a, rebase_every=every,
                                        options=solver._chunk_opts),
        P, V, Fx, solver._rb_extra(), HOLD_STEPS, every,
        options=solver._chunk_opts, iterations=ITERATIONS)


def same_bits(label, batched, solo, ulps=0):
    """Each sim of a batched call bit for bit against its solo call, or
    with ``ulps`` > 0 within that many float32 units of the solo state's
    largest entry."""
    for b, (x, y) in enumerate(zip(batched, solo)):
        d = holds.max_abs(x, y)
        tol = ulps * holds.F32_EPS * float(y.abs().max())
        holds.require(bool(torch.equal(x, y)) or (ulps and d <= tol),
                      f"{label}: sim {b} differs from the solo kernel by "
                      f"{d:.3e}" + (f" (limit {tol:.3e})" if ulps else ""))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def check_contact(dev):
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine_contact,
        resident_affine_contact_plain,
    )

    model = cloth()
    solver = solver_of(model, dev)
    holds.require(solver._resident_kind == "affine" and solver._contact_mode,
                  f"contact tier {solver._resident_kind}")
    model.positions = model.positions.copy()
    model.positions[:, 1] -= model.positions[:, 1].min() - 0.02
    f = gravity(model)
    P, V, Fx = state(solver, model, f)
    counted("contact", lambda: solver.run_steps(f, 64, ITERATIONS),
            must={kernel5(solver), "resident_affine_contact"})
    holds.require(np.isfinite(model.positions).all()
                  and model.positions[:, 1].min() > -0.5, "no floor response")
    hold_one_step("contact: kernel 3 (contact mode)", solver,
                  resident_affine_contact, resident_affine_contact_plain,
                  P, V, Fx)
    holds.carried_steps(
        torch, "contact: kernel 3 (contact mode)", "3c", solver._affine,
        lambda *a: resident_affine_contact_plain(*a, rebase_every=3),
        P, V, Fx, solver._rb_extra(), HOLD_STEPS, every=3,
        iterations=ITERATIONS)


def _group_check(label, model, dev):
    """tets / bend: run_steps(64) through the floor, kernel 1 against
    float64, kernel 5's carried steps."""
    solver = solver_of(model, dev)
    f = gravity(model)
    P, V, Fx = state(solver, model, f)
    counted(label, lambda: solver.run_steps(f, 64, ITERATIONS),
            must={kernel5(solver)}, may={"resident_affine_contact"})
    holds.require(np.isfinite(model.positions).all(), "non-finite state")
    hold_kernel1(solver, P, V, Fx)
    carried_kernel5(label, solver, P, V, Fx)


def check_tets(dev):
    from animsnapbases_tpu_torch.geometry.procedural import bar_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, T, F, _ = bar_model(4, 3, 3)
    model = DeformableModel(V, F, elements=T, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=2.0)
    model.add_tet_constrain_strain(0.95, 1.05, 1e4)
    model.add_tet_constrain_deformation_gradient(1e4)
    for i in np.where(V[:, 0] < V[:, 0].min() + 1e-6)[0]:
        model.fix(i)
    _group_check("tets", model, dev)


def check_bend(dev):
    _group_check("bend", cloth(bending=True), dev)


def batch(model, B, slam=None):
    """B sims from the model's state, sim b at (1 + 0.2 b) g, sim ``slam``
    at 40 g."""
    f = np.stack([gravity(model, 1.0 + 0.2 * b) for b in range(B)])
    if slam is not None:
        f[slam] = gravity(model, 40.0)
    pos = np.repeat(model.positions[None], B, axis=0)
    return pos, np.zeros_like(pos), f


def check_batched(dev):
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine_contact,
        resident_affine_contact_batched,
        resident_affine_contact_plain,
    )

    model = cloth()
    solver = solver_of(model, dev)
    B = 4
    pos, vel, f = batch(model, B, slam=B - 1)
    p, _ = counted("batched", lambda: solver.make_batched_run()(
        pos, vel, f, 64, num_iterations=ITERATIONS),
        must={"resident_affine_contact_batched"})
    holds.require(solver._last_batched_path == "batched-resident"
                  and np.isfinite(p).all(), solver._last_batched_path)
    ao, rb = solver._affine, solver._rb_extra()
    P, V, Fx = (solver._pack(x) for x in (pos, vel, f))
    Pb, Vb = resident_affine_contact_batched(ao, P, V, Fx, rb, 64,
                                             ITERATIONS)[:2]
    solo = [resident_affine_contact(ao, P[b], V[b], Fx[b], rb, 64,
                                    ITERATIONS)[:2] for b in range(B)]
    same_bits("batched kernel 3 (contact mode), P", Pb,
              [s[0] for s in solo])
    same_bits("batched kernel 3 (contact mode), V", Vb,
              [s[1] for s in solo])
    for b in (0, B - 1):
        hold_one_step(f"batched: sim {b}'s kernel 3 (contact mode)", solver,
                      resident_affine_contact, resident_affine_contact_plain,
                      P[b], V[b], Fx[b])


def check_batched_poke(dev):
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine_contact,
        resident_affine_contact_batched,
    )
    from animsnapbases_tpu_torch.sim.solver import (
        positional_targets_timeline,
    )

    def shift(amp, per=8, cycles=2):
        seg = np.concatenate([np.linspace(0.0, amp, per // 2),
                              np.linspace(amp, 0.0, per - per // 2)])
        s = np.zeros((cycles * per, 3))
        s[:, 2] = np.tile(seg, cycles)
        return s

    model = cloth()
    shifts = [shift(0.4), shift(-0.3, per=6)]
    model.add_positional_constraint(10, wi=1e6, motion_type="user_defined",
                                    frame_shift=shifts[0])
    solver = solver_of(model, dev)
    B = 2
    tls = []
    for s in shifts:
        model._positional[-1]["frame_shift"] = s
        tls.append(positional_targets_timeline(model, 0, 16)[0])
    model._positional[-1]["frame_shift"] = shifts[0]
    T = max(len(t) for t in tls)
    tl = np.stack([np.concatenate([t, np.repeat(t[-1:], T - len(t), 0)])
                   for t in tls])
    pos, vel, f = batch(model, B)
    p, _ = counted("batched_poke", lambda: solver.make_batched_run()(
        pos, vel, f, 16, num_iterations=8, targets_seq=tl),
        must={"resident_affine_contact_batched"})
    holds.require(np.isfinite(p).all(), "non-finite batch")
    ao = solver._affine
    rb = solver._rb_timeline(tl, B)                      # (B, T, 3, r)
    P, V, Fx = (solver._pack(x) for x in (pos, vel, f))
    Pb, _ = resident_affine_contact_batched(ao, P, V, Fx, rb, 16, 8)[:2]
    same_bits("batched_poke: batched kernel 3 on per-sim schedules", Pb,
              [resident_affine_contact(ao, P[b], V[b], Fx[b], rb[b], 16,
                                       8)[0] for b in range(B)])


def check_damped(dev):
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine_exit,
        resident_affine_exit_plain,
    )

    rng = np.random.default_rng(7)
    model = cloth()
    solver = solver_of(model, dev, damping=0.05)
    holds.require(abs(solver.eta - 0.95) < 1e-12, f"eta {solver.eta}")
    v0 = rng.normal(scale=0.5, size=model.positions.shape)
    v0[model.fixed_flags] = 0.0
    f0 = np.zeros_like(model.positions)
    speed0 = float(np.linalg.norm(v0))
    for label, switches, must in (
            ("damped, contact mode", {}, {kernel5(solver)}),
            ("damped, lean tier-1 exit", {"resident_contact_mode": False,
                                          "resident_chunked_tier1": False},
             {"resident_affine_exit"})):
        for k, v in switches.items():
            setattr(solver, k, v)
        solver.prepare(solver.args)
        model.positions = model.positions.copy()
        model.velocities = v0.copy()
        counted(label, lambda: solver.run_steps(f0, 128, ITERATIONS),
                must=must, may={"resident_affine", "resident_affine_contact"})
        speed1 = float(np.linalg.norm(model.velocities))
        holds.require(np.isfinite(model.positions).all()
                      and speed1 < 0.5 * speed0,
                      f"{label}: no decay ({speed0:.3f} -> {speed1:.3f})")
    P, V, Fx = state(solver, model, f0)
    hold_one_step("damped: kernel 4", solver, resident_affine_exit,
                  resident_affine_exit_plain, P, V, Fx)


def _large_route(label, model, solver):
    """Tier 1 (kernel 5) serving a 600-step ring-down whole, then a floor
    slam handed to kernel 2; kernel 5's carried steps and kernel 2's
    one-step calls held."""
    from animsnapbases_tpu_torch.ops.resident import (
        resident_multistep,
        resident_multistep_plain,
    )

    holds.require(solver._resident_kind == "standard",
                  f"{label}: contact tier {solver._resident_kind}")
    rng = np.random.default_rng(11)
    v0 = rng.normal(scale=0.2, size=model.positions.shape)
    v0[model.fixed_flags] = 0.0
    model.velocities = v0.copy()
    f0 = np.zeros_like(model.positions)
    P, V, F0 = state(solver, model, f0)
    counted(f"{label}, ring-down", lambda: solver.run_steps(
        f0, 600, ITERATIONS), must={kernel5(solver)})
    holds.require(solver._last_fast_steps == 600,
                  f"{label}: tier 1 served {solver._last_fast_steps} of 600")
    carried_kernel5(label, solver, P, V, F0)
    f = gravity(model, 30.0)
    P, V, Fx = state(solver, model, f)
    counted(f"{label}, floor slam", lambda: solver.run_steps(
        f, 400, ITERATIONS), must={"resident_multistep"},
        may={kernel5(solver)})
    min_y = float(model.positions[:, 1].min())
    holds.require(np.isfinite(model.positions).all() and min_y >= -1e-4
                  and solver._last_fast_steps != 400,
                  f"{label}: floor slam min_y {min_y}, tier 1 "
                  f"{solver._last_fast_steps}")
    hold_one_step(f"{label}: kernel 2", solver, resident_multistep,
                  resident_multistep_plain, P, V, Fx)
    log(f"[smoke] {label}: ring-down served whole; contact window min_y="
        f"{min_y:.4f}")


def check_chunked(dev):
    model = cloth()
    solver = solver_of(model, dev, damping=0.01)
    solver.CHUNKED_TIER1_MIN_VERTS = 4      # the large-model route, forced
    solver.prepare(solver.args)
    _large_route("chunked", model, solver)


def check_chunked_only(dev):
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    rows = math.isqrt(AnimSnapBasesSolver.CHUNKED_TIER1_MIN_VERTS - 1) + 1
    model = cloth(rows, rows)
    _large_route(f"chunked_only ({model.n_verts} vertices)", model,
                 solver_of(model, dev, damping=0.01))


def check_batched_chunked(dev):
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        affine_chunked,
        affine_chunked_batched,
    )

    model = cloth()
    solver = solver_of(model, dev, damping=0.01)
    solver.CHUNKED_TIER1_MIN_VERTS = 0
    solver.prepare(solver.args)
    run = solver.make_batched_run()
    B = 4
    rng = np.random.default_rng(17)
    pos = np.repeat(model.positions[None], B, axis=0)
    vel = rng.normal(scale=0.2, size=pos.shape)
    vel[:, model.fixed_flags] = 0.0
    f0 = np.zeros_like(pos)
    p, v = counted("batched_chunked, ring-down", lambda: run(
        pos, vel, f0, 600, num_iterations=ITERATIONS),
        must={kernel5(solver, batched=True)})
    holds.require(solver._last_batched_path == "batched-chunked",
                  solver._last_batched_path)
    ao, rb = solver._affine, solver._rb_extra()
    P, V, F0 = (solver._pack(x) for x in (pos, vel, f0))
    Pb, _, kb = affine_chunked_batched(ao, P, V, F0, rb, 16, ITERATIONS,
                                       rebase_every=solver._chunk_every,
                                       options=solver._chunk_opts)
    solo = [affine_chunked(ao, P[b], V[b], F0[b], rb, 16, ITERATIONS,
                           rebase_every=solver._chunk_every,
                           options=solver._chunk_opts) for b in range(B)]
    holds.require(kb == 16 and all(s[2] == 16 for s in solo),
                  f"batched_chunked: k {kb}, solo {[s[2] for s in solo]}")
    # the chunks' anchors are float64 torch products over the whole batch,
    # whose rounding depends on the batch size: a few float32 units
    same_bits("batched_chunked: batched kernel 5", Pb, [s[0] for s in solo],
              ulps=4)
    f = np.repeat(gravity(model, 30.0)[None], B, axis=0)
    p, _ = counted("batched_chunked, floor slam", lambda: run(
        p, v, f, 400, num_iterations=ITERATIONS),
        must={kernel5(solver, batched=True), "resident_multistep_batched"})
    holds.require(solver._last_batched_path.startswith(
        "batched-chunked+perstep") and np.isfinite(p).all(),
        solver._last_batched_path)


CHECKS = {"contact": check_contact, "tets": check_tets, "bend": check_bend,
          "batched": check_batched, "batched_poke": check_batched_poke,
          "damped": check_damped, "chunked": check_chunked,
          "chunked_only": check_chunked_only,
          "batched_chunked": check_batched_chunked}


def main(argv=None, device=None) -> int:
    """Run the checks named in ``argv`` (all by default) on ``device``
    (default the card) -> 0; exits non-zero without a card, on an unknown
    name, or at the first failure."""
    from animsnapbases_tpu_torch.device import resolve_device

    names = list(sys.argv[1:] if argv is None else argv) or list(CHECKS)
    unknown = [n for n in names if n not in CHECKS]
    if unknown:
        sys.exit(f"[smoke] unknown check(s) {unknown}; "
                 f"available: {sorted(CHECKS)}")
    if device is None and not torch.cuda.is_available():
        sys.exit("[smoke] no CUDA device: this battery holds the kernels on "
                 "the card, and a CPU run would hold none of them")
    dev = resolve_device(device)
    log(f"[smoke] device={dev} "
        f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else ''}")
    for name in names:
        t0 = time.perf_counter()
        CHECKS[name](dev)
        torch.cuda.synchronize()
        print(f"PASS {name} ({time.perf_counter() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
