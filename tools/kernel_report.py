"""Registers and spills of every CUDA kernel of one source tree (each
build of kernel 5 in a tree that has them: ``affine_chunk<T, M, O>`` with
O the build's option bits, ops/affine_chunked.py ChunkOptions.code), and
the times of kernels 1 and 5 that compare two trees.

    python3 tools/kernel_report.py <tree>

``<tree>`` is a checkout of the repository whose package is imported (its
kernels are built under ``<tree>/build/kernels`` with ``nvcc -Xptxas -v``);
the scenes come from this script's own checkout (``chip_smoke``), so an
older tree is measured on the same scenes.  Prints, per kernel and per
out-of-line device function, what ptxas reports (registers, stack frame,
spill stores and loads), then on the bench scene (10 iterations):

* kernel 1: a call between two CUDA events (the wrapper's host time
  included, median of 200: ``ms`` of chip_smoke.py's kernels line) and the
  kernel's device time per launch (200 launches back to back after half a
  second of calls, median of three runs, ``chip_smoke.device_ms``), and
  the device time at 0 and 20 iterations (slope per iteration, intercept
  per call);
* kernel 5: 64-step calls at 0 and 20 iterations (slope per iteration and
  intercept per step as in chip_smoke.py's kernels line); µs per step over
  the 2,000-step tier-1 window of ``chip_smoke.py`` (median of 10), and at
  20 iterations (slope per iteration against 10, intercept per step; with
  none the window would reach the floor); the window on the exact-free
  build and 64-step calls on the build without the bound against the
  default (the exact floor check's cost per step);
* batched: kernel 1 on 64 sims (device time per launch) and kernel 5 on 8
  ring-down sims over the window (µs per step);
* the staging plans, in a tree with the cluster loop (kernels 2-4: in a
  tree that runs them on it, with the clusters the card holds at once on
  each and, batched, the plan a launch of 8, 64 and 128 sims takes);

then the megacloth of ``chip_smoke.scale_phase`` (250,000 vertices):
kernel 5's exact and exact-free builds over 2,000-step calls at rest, and
64-step calls of the build without the bound (the exact check's cost).
To compare two commits on one card, in one call::

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/kernel_report.py $t; done

(the ptxas lines are long: send the output to a file).
"""
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

tree = sys.argv[1]
sys.path[0] = tree
import torch  # noqa: E402
from animsnapbases_tpu_torch.device import resolve_device  # noqa: E402
from animsnapbases_tpu_torch.ops import _build  # noqa: E402
from animsnapbases_tpu_torch.ops import fused_reduced as k1mod  # noqa: E402
from animsnapbases_tpu_torch.ops.affine_chunked import (  # noqa: E402
    ChunkOptions, affine_chunked, affine_chunked_batched)
from animsnapbases_tpu_torch.ops.resident import (  # noqa: E402
    force_term, predict)

ITERS = cs.ITERATIONS
WINDOW = cs.WINDOW_STEPS


def demangle(names):
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(log):
    """[(function, registers or None, stack, spill stores, spill loads)]
    of a ptxas -v log."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            rows.append([name, None, 0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and rows:
            rows[-1][2:] = [int(x) for x in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1][1] = int(m.group(1))
    names = demangle([r[0] for r in rows])
    return [(n.split("(")[0], *r[1:]) for n, r in zip(names, rows)]


def say(what):
    print(f"{tree} {what}", flush=True)


def per_step(ms, steps):
    return f"{1e3 * ms / steps:.2f} us/step"


print("package:", _build.__file__, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
dev = resolve_device("cuda")
info = _build.build()
for src in sorted(info):
    for fn, regs, stack, st, ld in ptxas_report(info[src]["log"]):
        say(f"{src}: {fn}: registers {regs}, stack {stack} B, "
            f"spill stores {st} B, spill loads {ld} B")

# ---- the bench scene ------------------------------------------------------
model, s = cs.bench_solver(torch, dev)
ro, ao = s._resident, s._affine
fo = ro.fused
f = cs.gravity(model)
P, V, Fx = (s._to_device(x) for x in (model.positions, model.velocities, f))
rb = s._rb_extra()
sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb)
snT = sn[:, :ro.n_sel]


def k1(it):
    return lambda: k1mod.fused_reduced_iterations(fo, snT, rb_const, it)


call = cs.cuda_ms(torch, k1(ITERS), reps=200)
dev_k1 = {it: cs.device_ms(torch, k1(it), reps=200)
          for it in (0, ITERS, 20)}
say(f"bench scene: kernel 1 {1e3 * call:.2f} us/call (events); device "
    f"{1e3 * dev_k1[ITERS]:.2f} us/launch; at 0 and 20 iterations "
    f"{1e3 * dev_k1[0]:.2f} and {1e3 * dev_k1[20]:.2f} us: slope "
    f"{1e3 * (dev_k1[20] - dev_k1[0]) / 20:.3f} us/iteration, intercept "
    f"{1e3 * dev_k1[0]:.2f} us/call")
clustered = hasattr(k1mod, "fused_plan")   # a tree with the cluster loop

s.step(f, num_iterations=ITERS)
s.run_steps(f, cs.SCENE_STEPS, num_iterations=ITERS)
Pw = s._to_device(model.positions)
Vw = 0.1 * s._to_device(model.velocities)
F0 = torch.zeros_like(Pw)
k = affine_chunked(ao, Pw, Vw, F0, rb, WINDOW, ITERS)[2]
assert k == WINDOW, f"the window is not contact-free ({k})"
at = {it: cs.cuda_ms(torch, lambda it=it: affine_chunked(
    ao, Pw, Vw, F0, rb, cs.SCENE_STEPS, it)) for it in (0, 20)}
say(f"bench scene: kernel 5 {cs.SCENE_STEPS}-step calls at 0 and 20 "
    f"iterations {per_step(at[0], cs.SCENE_STEPS)} and "
    f"{per_step(at[20], cs.SCENE_STEPS)}: slope "
    f"{1e3 * (at[20] - at[0]) / (20 * cs.SCENE_STEPS):.3f} us/iteration, "
    f"intercept {per_step(at[0], cs.SCENE_STEPS)}")
k5 = cs.cuda_ms(torch, lambda: affine_chunked(ao, Pw, Vw, F0, rb, WINDOW,
                                              ITERS), reps=10, warmup=1)
k = affine_chunked(ao, Pw, Vw, F0, rb, WINDOW, 20)[2]
assert k == WINDOW, f"the window at 20 iterations is not contact-free ({k})"
k5_20 = cs.cuda_ms(torch, lambda: affine_chunked(ao, Pw, Vw, F0, rb, WINDOW,
                                                 20), reps=5, warmup=1)
slope = 1e3 * (k5_20 - k5) / ((20 - ITERS) * WINDOW)
say(f"bench scene: kernel 5 {per_step(k5, WINDOW)} over {WINDOW} steps, at "
    f"20 iterations {per_step(k5_20, WINDOW)}: slope {slope:.3f} "
    f"us/iteration, intercept {1e3 * k5 / WINDOW - ITERS * slope:.2f} "
    f"us/step")
free, bound_off = ChunkOptions(floor_exact=False), ChunkOptions(
    floor_bound_skip=False)
ms = cs.cuda_ms(torch, lambda: affine_chunked(
    ao, Pw, Vw, F0, rb, WINDOW, ITERS, options=free), reps=10, warmup=1)
say(f"bench scene: kernel 5 exact-free {per_step(ms, WINDOW)} over "
    f"{WINDOW} steps")
t = cs.in_turns(torch, {key: lambda o=o: affine_chunked(
    ao, Pw, Vw, F0, rb, cs.SCENE_STEPS, ITERS, options=o) for key, o in (
        ("default", ChunkOptions()), ("bound off", bound_off))}, 20)
say(f"bench scene: kernel 5 {cs.SCENE_STEPS}-step calls in turns: default "
    f"{per_step(t['default'], cs.SCENE_STEPS)}, bound off "
    f"{per_step(t['bound off'], cs.SCENE_STEPS)}: the exact check "
    f"{1e3 * (t['bound off'] - t['default']) / cs.SCENE_STEPS:.2f} us/step")

# ---- batched ---------------------------------------------------------------
B1, B5 = cs.ENSEMBLE, 8
g = torch.Generator().manual_seed(0)
jit = 1e-3 * torch.randn(B1, 1, 1, generator=g).to(dev)
snb = (snT[None] * (1 + jit)).contiguous()
rbb = (rb_const[None] * (1 + jit)).contiguous()
ms = cs.device_ms(torch, lambda: k1mod.fused_reduced_iterations_batched(
    fo, snb, rbb, ITERS), reps=100)
call = cs.cuda_ms(torch, lambda: k1mod.fused_reduced_iterations_batched(
    fo, snb, rbb, ITERS), reps=100)
say(f"bench scene: kernel 1 batched, {B1} sims: device {1e3 * ms:.2f} "
    f"us/launch, {1e3 * call:.2f} us/call (events)")
Pb = torch.stack([Pw] * B5).contiguous()
Vb = torch.stack([(1 - cs.SPREAD * b) * Vw for b in range(B5)]).contiguous()
Fb = torch.zeros_like(Pb)
ms = cs.cuda_ms(torch, lambda: affine_chunked_batched(
    ao, Pb, Vb, Fb, rb, WINDOW, ITERS), reps=3, warmup=1)
say(f"bench scene: kernel 5 batched, {B5} sims: {per_step(ms, WINDOW)} over "
    f"{WINDOW} steps, {B5 * WINDOW / (ms / 1e3):.0f} aggregate steps/s")

# ---- staging plans ---------------------------------------------------------
if clustered:
    from animsnapbases_tpu_torch.ops.affine_chunked import chunk_plan
    say(f"staging plan, kernel 1: {k1mod.fused_plan(fo).as_dict()}")
    say(f"staging plan, kernel 5: {chunk_plan(ao).as_dict()}")
from animsnapbases_tpu_torch.ops import affine as k3mod  # noqa: E402
if hasattr(k3mod, "affine_plan"):   # kernels 2-4 on the cluster loop
    from animsnapbases_tpu_torch.ops.cluster import resident_clusters
    from animsnapbases_tpu_torch.ops.resident import resident_plan
    for name, lib, plan_of in (("kernel 2", "resident",
                                lambda B: resident_plan(ro, B)),
                               ("kernels 3 and 4", "affine",
                                lambda B: k3mod.affine_plan(ao, B))):
        for B in (1, 8, 64, 128):
            plan = plan_of(B)
            say(f"staging plan, {name}, {B} sims: {list(plan.staged)}, "
                f"{plan.smem_bytes} B a block, "
                f"{resident_clusters(lib, plan)} clusters resident")

# ---- the megacloth -----------------------------------------------------------
mmodel, ms_ = cs.megacloth_solver(torch, dev)
mao = ms_._affine
Pm = ms_._to_device(mmodel.positions)
Vm = ms_._to_device(mmodel.velocities)
F0m = torch.zeros_like(Pm)
rbm = ms_._rb_extra()
t = cs.in_turns(torch, {key: lambda o=o: affine_chunked(
    mao, Pm, Vm, F0m, rbm, WINDOW, ITERS, options=o) for key, o in (
        ("exact", ChunkOptions()), ("exact-free", free))}, 5)
say(f"megacloth: kernel 5 at rest, {WINDOW}-step calls in turns: " + ", ".join(
    f"{key} {per_step(v, WINDOW)}" for key, v in t.items()))
t = cs.in_turns(torch, {key: lambda o=o: affine_chunked(
    mao, Pm, Vm, F0m, rbm, cs.SCENE_STEPS, ITERS, options=o) for key, o in (
        ("default", ChunkOptions()), ("bound off", bound_off))}, 5)
say(f"megacloth: kernel 5 {cs.SCENE_STEPS}-step calls in turns: default "
    f"{per_step(t['default'], cs.SCENE_STEPS)}, bound off "
    f"{per_step(t['bound off'], cs.SCENE_STEPS)}: the exact check "
    f"{1e3 * (t['bound off'] - t['default']) / cs.SCENE_STEPS:.2f} us/step")
if clustered:
    say(f"staging plan, kernel 5, megacloth: {chunk_plan(mao).as_dict()}")
