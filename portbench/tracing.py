"""The benchmark's spans and its reading of the device trace.

The benchmark calls ``torch.profiler`` itself (CPU and CUDA activity) over
the traced window and keeps the profile in memory; it writes nothing to
disk.  Its own spans are ``record_function`` ranges in the same trace:
``portbench.window`` around the window, ``portbench.call`` around each call
of the entry point, ``portbench.inputs`` around the making of a request's
inputs.  :func:`summarize` reduces the trace to what the per-layer readers
and the result's ``breakdown`` need:

* the device intervals (kernels, copies, sets) inside the window, their
  union (``busy_s``) and the idle gaps between them, each labelled by the
  innermost host event running when the gap began (a torch operator, a
  CUDA runtime call or one of the benchmark's spans);
* device seconds by operation name, and those of the program's kernels
  (names in the ``ksm::`` namespace of ``csrc/``);
* each call's span and the device-busy seconds inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import re

KERNEL_NAMESPACE = "ksm::"
SPAN_PREFIX = "portbench."
WINDOW, CALL, INPUTS = (SPAN_PREFIX + "window", SPAN_PREFIX + "call",
                        SPAN_PREFIX + "inputs")


class Tracer:
    """Spans always; the profiler only when ``enabled``."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def start(self):
        if not self.enabled:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def stop(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def summary(self):
        """:func:`summarize` of the profile's raw events: read as the
        profiler recorded them, without the event tree that
        ``prof.events()`` builds (ten times slower, and gigabytes for a
        window of a million kernels)."""
        if self.prof is None:
            return None
        return summarize(
            (str(e.device_type()).split(".")[-1], e.start_ns() * 1e-3,
             e.end_ns() * 1e-3, e.name())
            for e in self.prof.profiler.kineto_results.events())


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments, at most 120 characters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(union, ends, a, b):
    """Time of the sorted union (its interval ends ``ends``) inside [a,
    b] (times in us)."""
    i = bisect.bisect_right(ends, a)
    total = 0.0
    while i < len(union) and union[i][0] < b:
        total += min(b, union[i][1]) - max(a, union[i][0])
        i += 1
    return total


def summarize(events) -> dict:
    """``events``: (device type, start us, end us, name) of each event."""
    cpu, dev = [], []
    for kind, start, end, name in events:
        if kind == "CUDA":
            # the benchmark's own spans are mirrored on the device's
            # timeline as annotations: they are not device work
            if not name.startswith(SPAN_PREFIX):
                dev.append((start, end, name))
        else:
            cpu.append((start, end, name))
    windows = [(a, b) for a, b, n in cpu if n == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    union = _union([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in union)
    by_name, ksm = {}, 0.0
    for a, b, n in dev:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (b - a)
        if KERNEL_NAMESPACE in n:
            ksm += b - a
    gaps, prev = [], w0
    for a, b in union:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((a, b, n) for a, b, n in cpu if n != WINDOW)
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in gaps:
        label = "host outside any traced event"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= g0:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    calls = [(a, b) for a, b, n in cpu if n == CALL and a >= w0 and b <= w1]
    ends = [u[1] for u in union]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernel_s": ksm * 1e-6,
        "device_ops": sorted(((k, v * 1e-6) for k, v in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": sorted(((k, v * 1e-6) for k, v in idle.items()),
                            key=lambda kv: -kv[1]),
        "calls": [((b - a) * 1e-6, _overlap(union, ends, a, b) * 1e-6)
                  for a, b in calls],
    }
