"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It exits non-zero and prints no result when
the card is missing or fewer cards are present than the cell asks for, and
when the run has loaded ``jax``, ``jaxlib``, ``flax`` or the JAX package
(top-level module names, compared whole).  Otherwise the last line of its
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the correctness check compared beside its limit,
which also end its standard error.

``--control tf32`` runs the check's control instead (the reference in TF32
put in the program's place); it is not part of a benchmark run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# import the benchmark as the package ``portbench`` from the checkout's
# root, not its modules from the script's directory
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    a = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == a.workload),
                None)
    if cell is None:
        print(f"portbench: no workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {a.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    t_cuda = time.perf_counter()
    import animsnapbases_tpu_torch  # noqa: F401  (the system under test)
    from portbench import core

    core.log(f"portbench: start (s): torch {t_torch - T_START:.3f}, card "
             f"{t_cuda - t_torch:.3f}, the program and the benchmark "
             f"{time.perf_counter() - t_cuda:.3f}")

    result = core.run(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                      device="cuda", t_start=T_START, control=a.control)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
