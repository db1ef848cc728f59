"""Where a benchmark call's host time goes: the device-idle time of a
traced run of one cell, split by the program's ``asb.*`` spans
(``animsnapbases_tpu_torch/utils/profiling.py``).

    python3 tools/span_split.py --workload <cell> --seed <n> \
        [--seconds 20] [--out <file.json>]

from the root of a checkout, on the card.  It runs the cell as
``portbench/run.py --trace 1`` does (``portbench.core.run``) and reads the
same profile: the device's busy union (kernels, copies, sets; user
annotations on the device's timeline left out), and inside each call of
the window the idle time by the innermost program span open
(``entry self``: inside a call, outside every program span), by each
span's name (its union of spans less the busy time inside it), and for
the groups ``transfers`` (``asb.to_device``, ``asb.to_host``,
``asb.pack``, ``asb.unpack``) and ``tiers`` (``asb.tier1``,
``asb.contact_tier``, ``asb.batched_kernel``), each moment once.  It
prints one JSON object with the split in milliseconds a call beside the
result's metrics.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import core, tracing  # noqa: E402

PROGRAM_PREFIX = "asb."
ENTRY_SELF = "entry self"
GROUPS = {"transfers": ("asb.to_device", "asb.to_host", "asb.pack",
                        "asb.unpack"),
          "tiers": ("asb.tier1", "asb.contact_tier", "asb.batched_kernel")}


def split(events) -> dict:
    """``events``: (device type, start us, end us, name, user annotation)
    -> the split of the window's calls (seconds)."""
    cpu, dev = [], []
    for kind, a, b, name, note in events:
        if kind == "CUDA":
            if not note:
                dev.append((a, b))
        else:
            cpu.append((a, b, name))
    window = [(a, b) for a, b, n in cpu if n == tracing.WINDOW][0]
    calls = [(a, b) for a, b, n in cpu if n == tracing.CALL
             and a >= window[0] and b <= window[1]]
    union = tracing._union(dev)
    ends = [u[1] for u in union]
    spans = sorted(s for s in cpu if s[2].startswith(PROGRAM_PREFIX))
    starts = [s[0] for s in spans]
    innermost, by_cover, total = {}, {}, 0.0
    for c0, c1 in calls:
        inside = spans[bisect.bisect_left(starts, c0):
                       bisect.bisect_right(starts, c1)]
        cuts = sorted({c0, c1, *(min(max(t, c0), c1) for a, b, _ in inside
                                 for t in (a, b))})
        for t0, t1 in zip(cuts, cuts[1:]):
            idle = (t1 - t0 - tracing._overlap(union, ends, t0, t1)) * 1e-6
            if idle <= 0:
                continue
            total += idle
            active = [s for s in inside if s[0] <= t0 and s[1] >= t1]
            cover = frozenset(n for _, _, n in active)
            by_cover[cover] = by_cover.get(cover, 0.0) + idle
            inner = (max(active, key=lambda s: (s[0], -s[1]))[2] if active
                     else ENTRY_SELF)
            innermost[inner] = innermost.get(inner, 0.0) + idle
    by_name = {}
    for cover, s in by_cover.items():
        for n in cover:
            by_name[n] = by_name.get(n, 0.0) + s
    groups = {g: sum(s for cover, s in by_cover.items() if cover & set(ns))
              for g, ns in GROUPS.items()}
    return {"calls": len(calls), "idle_s": total, "innermost": innermost,
            "by_name": by_name, "groups": groups}


class SplitTracer(tracing.Tracer):
    """The benchmark's tracer, which also keeps the split of its profile."""
    last = None

    def summary(self):
        if self.prof is not None:
            SplitTracer.last = split(
                (str(e.device_type()).split(".")[-1], e.start_ns() * 1e-3,
                 e.end_ns() * 1e-3, e.name(), e.is_user_annotation())
                for e in self.prof.profiler.kineto_results.events())
        return super().summary()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="a checkout's root (default: this one)")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    core.Tracer = SplitTracer
    result = core.run(Path(a.root), a.workload, a.seed, a.seconds, True,
                      device=a.device)
    s = SplitTracer.last
    per_call = 1e3 / max(s["calls"], 1)
    out = {"workload": a.workload, "seed": a.seed,
           "device": result["device"], "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "calls": s["calls"],
           "idle_ms_per_call": s["idle_s"] * per_call,
           "innermost_ms_per_call": {k: v * per_call for k, v in sorted(
               s["innermost"].items(), key=lambda kv: -kv[1])},
           "by_name_ms_per_call": {k: v * per_call
                                   for k, v in sorted(s["by_name"].items())},
           "groups_ms_per_call": {k: v * per_call
                                  for k, v in s["groups"].items()}}
    text = json.dumps(out)
    if a.out:
        Path(a.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
