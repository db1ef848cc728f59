"""Time kernels 2-5 of one source tree on the scenes of ``chip_smoke.py``
(10 iterations, CUDA events, medians), and break one call of kernels 2,
3, 3' and 4 down by CUDA kernel under torch.profiler.

    python3 tools/time_solo_kernels.py <tree>

``<tree>`` is a checkout of the repository whose package is imported (its
kernels are built under ``<tree>/build/kernels``); the scenes come from
this script's own checkout (``chip_smoke``), so an older tree is timed on
the same scenes.  It prints, in µs per step:

* solo, 64-step calls (median of 20): kernels 2, 3 (lean), 4 and 5 on free
  steps (the rest state moving at 0.05 sin(x) in y, no force), kernel 3
  in contact mode on them, and kernels 2, 3 and 3' on the contact scene;
* the ring-down ensemble (``chip_smoke.ensemble_state`` from the main
  path's end) over the 2,000-step window at B = 1, 8, 64 and 128 sims on
  kernel 3' (the default route) and kernel 3 lean (B = 1: the solo
  kernel), median of 3;
* the crumpling ensemble (64 sims, 64-step calls, median of 10) on kernels
  3' and 3, and batched kernel 2 at 8 and 64 ring-down sims;
* the megacloth's near-floor window of ``chip_smoke.scale_phase`` (250,000
  vertices, r = 48) on kernel 2, 64-step calls (median of 10);
* per CUDA kernel, the device µs per step of one 64-step call of kernel 2
  (contact scene), 3 (free steps), 3' (contact scene) and 4 (free steps),
  the host time per step and the device's idle time per step between
  launches;
* in a tree whose batched launches choose a staging plan by waves
  (``ops/cluster.py`` ``launch_plan``): the ring-down window at 64 and 128
  sims on kernels 3' and 3, and batched kernel 2 at 64 and 128 sims, on
  the chosen plan and on the full plan, in turns (chosen, full, full,
  chosen; median of 3 each).

To compare two commits on one card, in one call::

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/time_solo_kernels.py $t; done
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

tree = sys.argv[1]
sys.path[0] = tree
import numpy as np  # noqa: E402
import torch  # noqa: E402
from animsnapbases_tpu_torch.device import resolve_device  # noqa: E402
from animsnapbases_tpu_torch.ops import _build  # noqa: E402
from animsnapbases_tpu_torch.ops.affine import (  # noqa: E402
    resident_affine, resident_affine_batched, resident_affine_contact,
    resident_affine_contact_batched, resident_affine_exit)
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked  # noqa
from animsnapbases_tpu_torch.ops.resident import (  # noqa: E402
    resident_multistep, resident_multistep_batched)

STEPS, WINDOW, ITERS = cs.SCENE_STEPS, cs.WINDOW_STEPS, cs.ITERATIONS


def say(what):
    print(f"{tree} {what}", flush=True)


def us(ms, steps):
    return 1e3 * ms / steps


print("package:", _build.__file__, flush=True)
dev = resolve_device("cuda")
_build.build()
model, s = cs.bench_solver(torch, dev)
ao, ro = s._affine, s._resident
f = cs.gravity(model)
rb = s._rb_extra()
P = s._to_device(model.positions)
v = np.zeros_like(model.positions)
v[:, 1] = 0.05 * np.sin(np.linspace(0, 6.28, len(v)))
V = s._to_device(v)
F0 = torch.zeros_like(P)
Fx = s._to_device(f)
Pc, Vc = (s._to_device(x) for x in cs.contact_state(model))

# ---- solo ------------------------------------------------------------------
calls = {"k2": lambda: resident_multistep(ro, P, V, F0, rb, STEPS, ITERS)}
for name, fn in (("k3", resident_affine), ("k4", resident_affine_exit),
                 ("k5", affine_chunked), ("k3'", resident_affine_contact)):
    calls[name] = lambda fn=fn: fn(ao, P, V, F0, rb, STEPS, ITERS)
calls["k2 contact scene"] = lambda: resident_multistep(
    ro, Pc, Vc, Fx, rb, STEPS, ITERS)
calls["k3 contact scene"] = lambda: resident_affine(
    ao, Pc, Vc, Fx, rb, STEPS, ITERS)
calls["k3' contact scene"] = lambda: resident_affine_contact(
    ao, Pc, Vc, Fx, rb, STEPS, ITERS)
out = {k: us(cs.cuda_ms(torch, fn, reps=20), STEPS)
       for k, fn in calls.items()}
say("solo: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items())
    + " us/step")

# ---- batched ----------------------------------------------------------------
s.step(f, num_iterations=ITERS)
s.run_steps(f, STEPS, num_iterations=ITERS)
main_state = (model.positions.copy(), model.velocities.copy())
for name, solo, many in (
        ("k3'", resident_affine_contact, resident_affine_contact_batched),
        ("k3", resident_affine, resident_affine_batched)):
    ring = {}
    for B in cs.ENSEMBLE_SIZES:
        Pe, Ve, Fe = (s._pack(x) for x in cs.ensemble_state(main_state, B))
        if B == 1:
            call = (lambda: solo(ao, Pe[0], Ve[0], Fe[0], rb, WINDOW, ITERS))
        else:
            call = (lambda: many(ao, Pe, Ve, Fe, rb, WINDOW, ITERS))
        ring[B] = us(cs.cuda_ms(torch, call, reps=3, warmup=1), WINDOW)
    say(f"ring-down over {WINDOW} steps, {name}: " + ", ".join(
        f"B={B} {v:.2f}" for B, v in ring.items()) + " us/step")
Pk, Vk, Fk = (s._pack(x) for x in cs.crumple_state(model, f))
crumple = {name: us(cs.cuda_ms(torch, lambda fn=fn: fn(
    ao, Pk, Vk, Fk, rb, STEPS, ITERS), reps=10), STEPS)
    for name, fn in (("k3'", resident_affine_contact_batched),
                     ("k3", resident_affine_batched))}
say(f"crumpling ensemble, {cs.CRUMPLE} sims: " + ", ".join(
    f"{k} {v:.2f}" for k, v in crumple.items()) + " us/step")
P64, V64, F64 = (s._pack(x) for x in cs.ensemble_state(main_state,
                                                       cs.ENSEMBLE))
k2b = {B: us(cs.cuda_ms(torch, lambda B=B: resident_multistep_batched(
    ro, P64[:B], V64[:B], F64[:B], rb, STEPS, ITERS), reps=10), STEPS)
    for B in (8, cs.ENSEMBLE)}
say("batched k2, ring-down: " + ", ".join(
    f"B={B} {v:.2f}" for B, v in k2b.items()) + " us/step")

# ---- the step's launches ----------------------------------------------------
for name, call in (("k2", calls["k2 contact scene"]), ("k3", calls["k3"]),
                   ("k3'", calls["k3' contact scene"]), ("k4", calls["k4"])):
    wall, spent = cs.device_breakdown(torch, call)
    busy = sum(spent.values())
    say(f"{name} per step: host {1e6 * wall / STEPS:.2f} us, device busy "
        f"{1e6 * busy / STEPS:.2f} us, idle {1e6 * (wall - busy) / STEPS:.2f}"
        " us; device us/step by kernel: " + ", ".join(
            f"{k} {1e6 * v / STEPS:.2f}" for k, v in sorted(
                spent.items(), key=lambda kv: -kv[1])[:10]))

# ---- the megacloth's near-floor window on kernel 2 --------------------------
mmodel, ms_ = cs.megacloth_solver(torch, dev)
near = mmodel.positions.copy()
near[:, 1] += mmodel.floor_height + cs.MEGA_GAP - near[:, 1].min()
Pm = ms_._to_device(near)
Vm = torch.zeros_like(Pm)
Fm = ms_._to_device(cs.MEGA_GRAVITY * cs.gravity(mmodel))
ms = cs.cuda_ms(torch, lambda: resident_multistep(
    ms_._resident, Pm, Vm, Fm, ms_._rb_extra(), STEPS, ITERS), reps=10)
say(f"megacloth near-floor window, k2: {us(ms, STEPS):.2f} us/step")

# ---- the batched plan choice against the full plan --------------------------
from animsnapbases_tpu_torch.ops import affine as k3mod  # noqa: E402
from animsnapbases_tpu_torch.ops import resident as k2mod  # noqa: E402
if hasattr(k3mod, "affine_plan"):
    from animsnapbases_tpu_torch.ops.cluster import staging_plan
    chosen = {"k3": k3mod.affine_plan, "k2": k2mod.resident_plan}
    full = {"k3": lambda ao_, nb=1: staging_plan(
        "affine", ao_.fused.r, ao_.fused.g_total, ao_.fused.m_total,
        ao_.res.n_sel),
        "k2": lambda ro_, nb=1: staging_plan(
            "resident", ro_.fused.r, ro_.fused.g_total, ro_.fused.m_total)}

    def use(plans):
        k3mod.affine_plan, k2mod.resident_plan = plans["k3"], plans["k2"]

    for B in (cs.ENSEMBLE, 2 * cs.ENSEMBLE):
        Pe, Ve, Fe = (s._pack(x) for x in cs.ensemble_state(main_state, B))
        for name, call in (
                ("k3'", lambda: resident_affine_contact_batched(
                    ao, Pe, Ve, Fe, rb, WINDOW, ITERS)),
                ("k3", lambda: resident_affine_batched(
                    ao, Pe, Ve, Fe, rb, WINDOW, ITERS)),
                ("k2", lambda: resident_multistep_batched(
                    ro, Pe, Ve, Fe, rb, STEPS, ITERS))):
            steps = STEPS if name == "k2" else WINDOW
            t = {}
            for key in ("chosen", "full", "full", "chosen"):
                use(chosen if key == "chosen" else full)
                t.setdefault(key, []).append(us(cs.cuda_ms(
                    torch, call, reps=3, warmup=1), steps))
            use(chosen)
            plan = (k2mod.resident_plan(ro, B) if name == "k2"
                    else k3mod.affine_plan(ao, B))
            say(f"plan choice, {name}, B={B}: chosen stages "
                f"{list(plan.staged)}: " + ", ".join(
                    f"{k} {v[0]:.2f} {v[1]:.2f}" for k, v in t.items())
                + " us/step")
