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
    """Collects named phase durations; ``directory`` is where
    :meth:`flush` writes them unless it is given another."""

    def __init__(self, directory: str = ""):
        self.directory = directory
        self.records: list[tuple[str, float]] = []

    def path(self, directory: str | None = None) -> str:
        """``function_timings.txt`` under ``directory`` (default: the
        timer's)."""
        return os.path.join(self.directory if directory is None
                            else directory, "function_timings.txt")

    def record(self, name: str, seconds: float) -> None:
        self.records.append((name, seconds))

    def phase(self, name: str):
        """A context manager recording the seconds of its block under
        ``name``."""
        return _Phase(self, name)

    def flush(self, directory: str | None = None) -> str | None:
        """Write the records to :meth:`path` of ``directory`` -> that path
        (None with no record)."""
        if not self.records:
            return None
        path = self.path(directory)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for name, seconds in self.records:
                f.write(f"Function '{name}' executed in {seconds:.4f} "
                        "seconds.\n")
        return path


class _Phase:
    def __init__(self, timer: PhaseTimer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.record(self.name, time.perf_counter() - self.t0)
        return False


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
