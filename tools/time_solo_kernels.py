"""Time the solo kernels 2-5 of one source tree: 64-step calls on the bench
scene's free steps, CUDA events, median of 20; then the device time per
CUDA kernel of one 64-step call of kernels 3 and 4 (torch.profiler).

    python3 tools/time_solo_kernels.py <tree>

``<tree>`` is a checkout of the repository whose package is imported (its
kernels are built under ``<tree>/build/kernels``); the scene comes from
this script's own checkout (``chip_smoke.bench_solver``), so an older
tree is timed on the same scene.  To compare two commits on one card, in
one call::

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
    resident_affine, resident_affine_exit)
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked  # noqa
from animsnapbases_tpu_torch.ops.resident import resident_multistep  # noqa

print("package:", _build.__file__, flush=True)
dev = resolve_device("cuda")
_build.build()
model, s = cs.bench_solver(torch, dev)
ao, ro = s._affine, s._resident
P = s._to_device(model.positions)
v = np.zeros_like(model.positions)
v[:, 1] = 0.05 * np.sin(np.linspace(0, 6.28, len(v)))
V = s._to_device(v)
F0 = torch.zeros_like(P)
rb = s._rb_extra()
calls = {"k2": lambda: resident_multistep(ro, P, V, F0, rb, 64, 10)}
for name, fn in (("k3", resident_affine), ("k4", resident_affine_exit),
                 ("k5", affine_chunked)):
    calls[name] = lambda fn=fn: fn(ao, P, V, F0, rb, 64, 10)
out = {k: cs.cuda_ms(torch, fn, reps=20) / 64 * 1e3 for k, fn in calls.items()}
print(tree, " ".join(f"{k} {v:.2f}" for k, v in out.items()), "us/step",
      flush=True)
for name in ("k3", "k4"):
    _, spent = cs.device_breakdown(torch, calls[name])
    print(tree, name, "device us/step:", ", ".join(
        f"{k} {1e6 * v / 64:.2f}" for k, v in sorted(
            spent.items(), key=lambda kv: -kv[1])[:8]), flush=True)
