"""``chip_smoke.self_collision_phase`` (phase [8]: self-collision)
rehearsed on the CPU with the fakes of ``tests/test_torch_chip_smoke.py``
at its smallest sizes: a 12x12 cloth in place of the 160x160 one, r = 8,
a 48-step clear window, an 8-step fold, 4 iterations a step.  Scene (a)'s
ring-down window on tier 1 (kernel 5 alone) and
``self_collision_resident=False`` (kernel 1 alone), scene (b)'s proximity
path (kernel 1 with the pass) with each step rebuilt and held, the
probes against float64, the full-order solver's two modes; the kernels'
entries under ``self_collision``."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    KEYS,
    one_thread,
    rehearsal,
)

SMALL = {"SC_ROWS": 12, "SC_R": 8, "SC_WINDOW": 48, "SC_FOLD_STEPS": 8,
         "SC_DEPTH": 3, "SC_SHORT": 8, "SC_REPS": 1, "ITERATIONS": 4}


def test_chip_smoke_self_collision_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    paths = {}
    out = cs.self_collision_phase(torch, counted, paths, dev, "cpu, 0 W")
    assert sorted(out) == ["affine_chunked", "fused_reduced_iterations"]
    for name, entry in out.items():
        assert (KEYS - {"name", "route", "source", "replaces",
                        "library_ms"}) <= set(entry), name
        assert entry["bound_ms"] > 0 and entry["launches_path"] in paths
        assert {"probe_ms", "bound_ms_per_call", "pass_ms"} <= set(entry)
    k5, k1 = out["affine_chunked"], out["fused_reduced_iterations"]
    assert [(w["path"], w["steps"]) for w in k5["windows"]] == [
        ("tier 1", 48)]
    assert k5["end_clearance"] > cs.SC_MIN_DIST
    assert set(k5["window_seconds"]) == {
        "tier 1 (1 calls)", "lower bound (1 calls)",
        "exact probe (0 calls)", "other", "total"}
    assert k1["probe_after"] > k1["probe_before"] and k1["pushed"] > 0
    # the plain versions count no launches: the paths are there, zeroed
    assert {"self-collision: run_steps(48), clear",
            "self-collision: run_steps(8), fold",
            "self-collision: self_collision_resident=False"} == set(paths)
    text = capsys.readouterr().out
    for line in ("[8] (a) the clear tier: 144 vertices, 242 triangles",
                 "[8] (a) run_steps(48):",
                 "[8] (a) where the window's time goes",
                 "[8] (a) end state: probe",
                 "[3] (a) kernel 5, 3 steps one by one",
                 "[8] (a) self_collision_resident=False",
                 "[8] (b) the fold: 144 vertices",
                 "the served run's end state bit for bit: True",
                 "[8] FOM Solver, enable_self_collision='device'",
                 "[8] FOM Solver, enable_self_collision=True",
                 "[8] seconds:"):
        assert line in text, line
