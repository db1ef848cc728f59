"""Phase timing: wall-clock per pipeline stage under the stage's name.

Counterpart of ``log_time`` of ``animsnapbases_tpu/utils/timing.py``
(stdlib only): each decorated stage of the bases pipeline records its
seconds in one process-wide timer, which writes them to a
``function_timings.txt`` in the reference's line format.
"""

from __future__ import annotations

import functools
import os
import time


class PhaseTimer:
    """Collects named phase durations."""

    def __init__(self):
        self.records: list[tuple[str, float]] = []

    def record(self, name: str, seconds: float) -> None:
        self.records.append((name, seconds))

    def flush(self, directory: str) -> str | None:
        """Write the records to ``directory/function_timings.txt`` ->
        its path (None with no record)."""
        if not self.records:
            return None
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "function_timings.txt")
        with open(path, "w") as f:
            for name, seconds in self.records:
                f.write(f"Function '{name}' executed in {seconds:.4f} "
                        "seconds.\n")
        return path


_GLOBAL_TIMER = PhaseTimer()


def global_timer() -> PhaseTimer:
    return _GLOBAL_TIMER


def log_time(func=None):
    """Decorator recording wall-clock into the global timer under the
    function's name."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            _GLOBAL_TIMER.record(f.__name__, time.perf_counter() - t0)
            return out
        return wrapper

    if func is not None:
        return deco(func)
    return deco
