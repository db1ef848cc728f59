"""``chip_smoke.pipeline_phase`` (phase [6]: record, bases, reduced solve on
real bases) rehearsed on the CPU with the fakes of
``tests/test_torch_chip_smoke.py``: kernels 1 and 5 on real bases, each
with its plan at the recorded r, its error against the plain version, its
times and bound, the reduced-vs-FOM statistic and the recording against
the CPU's."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    PLAN_KEYS,
    one_thread,
    rehearsal,
)


def test_chip_smoke_pipeline_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    real = cs.pipeline_phase(torch, counted, {}, dev)
    assert sorted(real) == ["affine_chunked", "fused_reduced_iterations"]
    for entry in real.values():
        assert {"launches", "launches_path", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "staging_plan",
                "vs_fom", "record_vs_cpu", "pipeline_s"} <= set(entry)
        assert PLAN_KEYS <= set(entry["staging_plan"])
        assert entry["bound_ms"] > 0 and entry["record_vs_cpu"] <= 1e-6
        assert set(entry["vs_fom"]) == {"mean", "p99", "max"}
    assert real["affine_chunked"]["entry_steps_per_s"] > 0
    assert "step_ms" in real["fused_reduced_iterations"]
    out = capsys.readouterr().out
    for line in ("[6] pipeline: recorded 12 frames", "equals the first bit "
                 "for bit (trajectory and p-snapshots): True",
                 "the card's first 12 frames against the CPU's",
                 "[6] pipeline, tris_strain: the card's bases against the "
                 "CPU's", "reduced-vs-FOM after 12 steps",
                 "[6] pipeline on real bases: run_steps over 16 steps "
                 "(certified)", "pipeline, kernel 5 (ring-down state), "
                 "carried steps"):
        assert line in out, line
