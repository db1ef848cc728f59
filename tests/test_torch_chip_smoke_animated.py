"""``chip_smoke.animated`` (animated positional targets) rehearsed on the
CPU with the fakes of ``tests/test_torch_chip_smoke.py``, from the bench
scene's main path: every kernel with a schedule timed with it and with a
static term, each beside its bound; kernel 1 on the recorded run."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    SERVED,
    bench,
    one_thread,
)


def test_chip_smoke_animated_phase(monkeypatch):
    counted, b = bench(monkeypatch)
    anim = cs.animated(torch, counted, b.paths, b.main_state, b.dev)
    for name in SERVED:
        if name == "fused_reduced_iterations_batched":
            continue
        entry = anim[name]
        assert entry["launches"] >= 0, name
        if name != "fused_reduced_iterations":
            assert {"ms", "static_ms", "bound_ms", "static_bound_ms",
                    "max_abs_err"} <= set(entry), name
            assert entry["bound_ms"] > entry["static_bound_ms"] > 0
