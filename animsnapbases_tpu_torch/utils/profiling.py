"""Profiling: device traces and named regions.

Counterpart of ``animsnapbases_tpu/utils/profiling.py``.
:func:`device_trace` runs ``torch.profiler`` over the enclosed block (the
CPU, and the card where there is one) and writes a Chrome trace into
``log_dir``, which Perfetto or ``chrome://tracing`` opens;
:func:`annotate` names a region that shows in such a trace
(``torch.profiler.record_function``).  The per-stage wall clocks are
``utils/timing.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """Trace the enclosed block into ``log_dir/trace_<ns>.json``; yields
    the profiler (None when not ``enabled``).

        with device_trace("traces/step"):
            solver.run_steps(f, 1000)
    """
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the device trace."""
    with torch.profiler.record_function(name):
        yield
