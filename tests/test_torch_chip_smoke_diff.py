"""``chip_smoke.diff_phase`` (phase [9]: differentiable rollouts on phase
[6]'s bases) rehearsed on the CPU with the fakes of
``tests/test_torch_chip_smoke.py``: phase [6]'s recording and bases of the
14x14 cloth in a shared directory, then the phase's holds (the rollout and
its gradients with respect to the scales, a force multiplier and the
positional targets on the "card" against the CPU, the scales' gradient
against central differences), the ``--bench`` fit and the twin experiment
at 2 Adam steps each (too few to converge: the rehearsal's ``require``
lets those two verdicts pass, and ``tests/test_torch_fit_material.py``
holds the twin's convergence on the CPU at its full length)."""

import os
import tempfile

import torch

import chip_smoke as cs
from test_torch_chip_smoke import one_thread, rehearsal  # noqa: F401


def test_chip_smoke_diff_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    for name, value in (("DIFF_FIT_STEPS", 2), ("DIFF_HORIZON", 4),
                        ("DIFF_REPS", 1)):
        monkeypatch.setattr(cs, name, value)
    with tempfile.TemporaryDirectory() as work:
        cs.pipeline_phase(torch, counted, {}, dev, work=work)
        out = cs.diff_phase(torch, dev, "cpu, 0 W",
                            os.path.join(work, "card", "bases"),
                            os.path.join(work, "card", "pos_basis.npz"))
    assert set(out["card_vs_cpu"]) == {"trajectory", "scales", "force",
                                       "targets"}
    assert max(out["card_vs_cpu"].values()) <= out["card_vs_cpu_limit"]
    assert len(out["cond_Ar"]) == 3 and out["fd_best"] <= cs.DIFF_FD_TOL
    assert sorted(out["fd_rel"]) == sorted(cs.DIFF_FD_EPS)
    fit = out["bench_fit"]
    assert fit["adam_steps"] == 2 and fit["groups"] == ["tris_strain",
                                                        "edge_spring"]
    assert {"fitted_scales", "rel_err", "loss_first", "loss_last",
            "ms_per_adam_step", "forward_ms", "forward_backward_ms",
            "max_memory_allocated"} <= set(fit)
    assert fit["loss_last"] < fit["loss_first"]
    assert out["twin"]["horizon"] == 16 and out["seconds"] > 0
    text = capsys.readouterr().out
    for line in ("[9] diff, bench scene (N=196, r=10, 2 positional pins",
                 "[9] diff: central differences, the closest gap",
                 "[9] diff, the --bench fit (cpu, 0 W)",
                 "[9] diff, the twin experiment (cpu, 0 W)"):
        assert line in text, line
