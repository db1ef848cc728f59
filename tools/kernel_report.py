"""Registers and spills of every CUDA kernel of one source tree (each
build of kernel 5 in a tree that has them: ``affine_chunk<T, M, O>`` with
O the build's option bits, ops/affine_chunked.py ChunkOptions.code), and
the bench scene's kernel-1 call and kernel-5 window times.

    python3 tools/kernel_report.py <tree>

``<tree>`` is a checkout of the repository whose package is imported (its
kernels are built under ``<tree>/build/kernels`` with ``nvcc -Xptxas -v``);
the scene comes from this script's own checkout (``chip_smoke``), so an
older tree is measured on the same scene.  Prints, per kernel and per
out-of-line device function, what ptxas reports (registers, stack frame,
spill stores and loads), then kernel 1's time per call (10 iterations, the
predictor of the bench scene's rest state; CUDA events, median of 200) and
kernel 5's time per step over the 2,000-step tier-1 window of
``chip_smoke.py`` (median of 10), and in a tree with kernel 5's builds the
same window on its exact-free build and on the build without the bound
(whose difference from the default is the exact floor check's cost per
step).  To compare two commits on one card, in one call::

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/kernel_report.py $t; done
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
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked  # noqa
from animsnapbases_tpu_torch.ops.fused_reduced import (  # noqa: E402
    fused_reduced_iterations)
from animsnapbases_tpu_torch.ops.resident import (  # noqa: E402
    force_term, predict)


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


print("package:", _build.__file__, flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
dev = resolve_device("cuda")
info = _build.build()
for src in sorted(info):
    for fn, regs, stack, st, ld in ptxas_report(info[src]["log"]):
        print(f"{tree} {src}: {fn}: registers {regs}, stack {stack} B, "
              f"spill stores {st} B, spill loads {ld} B", flush=True)

model, s = cs.bench_solver(torch, dev)
ro, ao = s._resident, s._affine
f = cs.gravity(model)
P, V, Fx = (s._to_device(x) for x in (model.positions, model.velocities, f))
rb = s._rb_extra()
sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb)
k1 = cs.cuda_ms(torch, lambda: fused_reduced_iterations(
    ro.fused, sn[:, :ro.n_sel], rb_const, cs.ITERATIONS), reps=200)
s.step(f, num_iterations=cs.ITERATIONS)
s.run_steps(f, cs.SCENE_STEPS, num_iterations=cs.ITERATIONS)
Pw = s._to_device(model.positions)
Vw = 0.1 * s._to_device(model.velocities)
F0 = torch.zeros_like(Pw)
k = affine_chunked(ao, Pw, Vw, F0, rb, cs.WINDOW_STEPS, cs.ITERATIONS)[2]
assert k == cs.WINDOW_STEPS, f"the window is not contact-free ({k})"
k5 = cs.cuda_ms(torch, lambda: affine_chunked(
    ao, Pw, Vw, F0, rb, cs.WINDOW_STEPS, cs.ITERATIONS), reps=10, warmup=1)
print(f"{tree} bench scene: kernel 1 {1e3 * k1:.2f} us/call; kernel 5 "
      f"{1e3 * k5 / cs.WINDOW_STEPS:.2f} us/step over {cs.WINDOW_STEPS} "
      f"steps", flush=True)
try:
    from animsnapbases_tpu_torch.ops.affine_chunked import ChunkOptions
    builds = (("exact-free", ChunkOptions(floor_exact=False)),
              ("bound off", ChunkOptions(floor_bound_skip=False)))
except ImportError:          # a tree without kernel 5's builds
    builds = ()
for label, o in builds:
    ms = cs.cuda_ms(torch, lambda: affine_chunked(
        ao, Pw, Vw, F0, rb, cs.WINDOW_STEPS, cs.ITERATIONS, options=o),
        reps=10, warmup=1)
    print(f"{tree} bench scene: kernel 5 {label} "
          f"{1e3 * ms / cs.WINDOW_STEPS:.2f} us/step over {cs.WINDOW_STEPS} "
          f"steps", flush=True)
