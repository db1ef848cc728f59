"""Time kernel 3's contact-mode build against its lean build on one card,
in turns in one process (lean, contact, contact, lean), on the scenes of
``chip_smoke.py``: the contact scene and the tier-1 window's free steps
over 2,000 steps (solo), the crumpling ensemble of 64 sims with the
torch.profiler breakdown of each build, and the ring-down ensemble of 64
sims over 2,000 steps (batched).  Prints the time ratios and whether the
two conditions of ``resident_contact_mode``'s default hold: (a) the
contact scene runs faster in contact mode, (b) free steps run at most 3 %
slower on the tier-1 window and on the ring-down ensemble.  The last line
is one JSON object with every number.

    python3 tools/ab_contact_mode.py
"""
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from animsnapbases_tpu_torch.device import resolve_device  # noqa: E402
from animsnapbases_tpu_torch.ops import _build  # noqa: E402
from animsnapbases_tpu_torch.ops.affine import (  # noqa: E402
    resident_affine, resident_affine_batched, resident_affine_contact,
    resident_affine_contact_batched)

TURNS = ("lean", "contact", "contact", "lean")
STEPS, WINDOW, ITERS = cs.SCENE_STEPS, cs.WINDOW_STEPS, cs.ITERATIONS


def in_turns(call, reps, warmup, steps):
    """{"lean": [us/step, us/step], "contact": [...]} of ``call(build)``
    timed in TURNS."""
    us = {}
    for name in TURNS:
        us.setdefault(name, []).append(1e3 * cs.cuda_ms(
            torch, lambda: call(name), reps=reps, warmup=warmup) / steps)
    return us


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = resolve_device("cuda")
    _build.build()
    model, solver = cs.bench_solver(torch, dev)
    f = cs.gravity(model)
    solver.step(f, num_iterations=ITERS)
    solver.run_steps(f, STEPS, num_iterations=ITERS)
    main_state = (model.positions.copy(), model.velocities.copy())
    ao = solver._affine
    rb = solver._rb_extra()
    P, V, Fx = (solver._to_device(x) for x in (*main_state, f))
    Pw, Vw, F0 = P, 0.1 * V, torch.zeros_like(P)
    Pc, Vc = (solver._to_device(x) for x in cs.contact_state(model))
    solo = {"lean": resident_affine, "contact": resident_affine_contact}
    many = {"lean": resident_affine_batched,
            "contact": resident_affine_contact_batched}
    Pr, Vr, Fr = (solver._pack(x) for x in cs.ensemble_state(
        main_state, cs.ENSEMBLE))
    Pk, Vk, Fk = (solver._pack(x) for x in cs.crumple_state(model, f))
    us = {
        "contact scene": in_turns(lambda b: solo[b](
            ao, Pc, Vc, Fx, rb, STEPS, ITERS), cs.REPS, 3, STEPS),
        "tier-1 window": in_turns(lambda b: solo[b](
            ao, Pw, Vw, F0, rb, WINDOW, ITERS), 3, 1, WINDOW),
        "crumpling ensemble": in_turns(lambda b: many[b](
            ao, Pk, Vk, Fk, rb, STEPS, ITERS), 10, 3, STEPS),
        "ring-down ensemble": in_turns(lambda b: many[b](
            ao, Pr, Vr, Fr, rb, WINDOW, ITERS), 3, 1, WINDOW)}
    for scene, t in us.items():
        print(f"{scene}: us/step in turns (lean, contact, contact, lean) "
              + ", ".join(f"{x:.2f}" for x in (t["lean"][0], *t["contact"],
                                                t["lean"][1])), flush=True)
    profile = {}
    for name, call in many.items():
        wall, spent = cs.device_breakdown(torch, lambda: call(
            ao, Pk, Vk, Fk, rb, STEPS, ITERS))
        profile[name] = {"host_us_per_step": 1e6 * wall / STEPS,
                         "device_busy": sum(spent.values()) / wall,
                         "device_us_per_step": {
                             k: 1e6 * v / STEPS for k, v in spent.items()}}
        print(f"crumpling ensemble ({name}) under torch.profiler: "
              f"{1e6 * wall / STEPS:.2f} us/step host time, device busy "
              f"{100 * sum(spent.values()) / wall:.1f} %; device us/step: "
              + ", ".join(f"{k} {1e6 * v / STEPS:.2f}" for k, v in sorted(
                  spent.items(), key=lambda kv: -kv[1])[:9]), flush=True)
    med = statistics.median
    ratio = {scene: med(t["contact"]) / med(t["lean"])
             for scene, t in us.items()}
    held = {"a": ratio["contact scene"] < 1.0,
            "b": max(ratio["tier-1 window"], ratio["ring-down ensemble"])
            <= 1.03}
    print("contact mode / lean time: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ratio.items())
        + f"; (a) {'holds' if held['a'] else 'fails'}, (b) "
        f"{'holds' if held['b'] else 'fails'}", flush=True)
    print(json.dumps({"us_per_step_in_turns": us, "time_ratio": ratio,
                      "held": held, "crumple_profile": profile}))


if __name__ == "__main__":
    main()
