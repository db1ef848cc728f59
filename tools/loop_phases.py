"""Where an iteration of the cluster loop (csrc/iteration_cluster.cuh)
spends its time, in SM cycles per phase, on the bench scene of
``chip_smoke.py`` (10 iterations).

    python3 tools/loop_phases.py

Builds kernels 1 and 5 (default build) with ``-DKSM_LOOP_CLOCKS`` into
``build/kernels_clocks/``, beside the plain build, so that thread 0 of each
block of the first sim's cluster adds the cycles of each phase of every
iteration to a device counter (``LOOP_CLOCK``), and prints them per
iteration for each block: phase A (its own work: this block's row of
Vall, pushed to its peers), the exchange (waiting for the peers' rows),
the projections (its own column, then the block's last ones at the
barrier), phase C (its own work) and its barrier.  Kernel 1 over 200
calls; kernel 5 over a 1,000-step call on the tier-1 window.  The counters
cost a clock read and an atomic add per phase: the totals run a little
above the plain build's slope per iteration (chip_smoke.py,
tools/kernel_report.py).
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from animsnapbases_tpu_torch.device import resolve_device  # noqa: E402
from animsnapbases_tpu_torch.ops import _build  # noqa: E402
from animsnapbases_tpu_torch.ops.affine_chunked import (  # noqa: E402
    affine_chunked)
from animsnapbases_tpu_torch.ops.fused_reduced import (  # noqa: E402
    _launch_fused)
from animsnapbases_tpu_torch.ops.resident import (  # noqa: E402
    force_term, predict)

PHASES = ("phase A", "exchange", "projection (own)", "projection (block)",
          "phase C", "barrier")
CALLS = 200
STEPS = 1000

_build.NVCC_FLAGS.append("-DKSM_LOOP_CLOCKS")
_build.BUILD_DIR = _build.BUILD_DIR.parent / "kernels_clocks"


def read(lib):
    """The (3, 8) counters of ``lib``, zeroed after the read."""
    fn = _build.load(lib).loop_clocks_read
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 24)()
    _build.check(lib, fn(ctypes.addressof(buf)), "loop_clocks_read")
    return [list(buf[8 * d:8 * d + len(PHASES)]) for d in range(3)]


def show(label, clocks, iterations):
    for d, row in enumerate(clocks):
        print(f"{label}, block {d} (dimension {'xyz'[d]}): " + ", ".join(
            f"{name} {c / iterations:.0f}" for name, c in zip(PHASES, row))
            + f"; {sum(row) / iterations:.0f} cycles per iteration",
            flush=True)


print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
dev = resolve_device("cuda")
_build.build(("fused_reduced", "affine_chunked"))
model, s = cs.bench_solver(torch, dev)
ro, ao = s._resident, s._affine
f = cs.gravity(model)
P, V, Fx = (s._to_device(x) for x in (model.positions, model.velocities, f))
rb = s._rb_extra()
sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb)
snT = sn[:, :ro.n_sel]

_launch_fused(ro.fused, snT, rb_const, cs.ITERATIONS)
torch.cuda.synchronize()
read("fused_reduced")
for _ in range(CALLS):
    _launch_fused(ro.fused, snT, rb_const, cs.ITERATIONS)
torch.cuda.synchronize()
show("kernel 1", read("fused_reduced"), CALLS * cs.ITERATIONS)

s.step(f, num_iterations=cs.ITERATIONS)
s.run_steps(f, cs.SCENE_STEPS, num_iterations=cs.ITERATIONS)
Pw = s._to_device(model.positions)
Vw = 0.1 * s._to_device(model.velocities)
F0 = torch.zeros_like(Pw)
affine_chunked(ao, Pw, Vw, F0, rb, 1, cs.ITERATIONS)
torch.cuda.synchronize()
read("affine_chunked")
k = affine_chunked(ao, Pw, Vw, F0, rb, STEPS, cs.ITERATIONS)[2]
torch.cuda.synchronize()
assert k == STEPS, f"the window is not contact-free ({k})"
show("kernel 5", read("affine_chunked"), STEPS * cs.ITERATIONS)
