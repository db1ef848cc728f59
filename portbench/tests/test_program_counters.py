"""The readers of the program's counters (``portbench/program_counters.py``):
on hand-made counters, without them (a program that has none), and from a
traced run of a cell at test size in a process of its own, through
``portbench/run.py``."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import core, program_counters
from portbench.tests.tiny import ROOT, tiny_root

ZERO = dict.fromkeys(
    ("transfer.h2d_bytes", "transfer.d2h_bytes", "steps.tier1",
     "steps.contact_tier", "steps.kernel1", "sim_steps.batched_resident",
     "sim_steps.batched_chunked", "device.launches", "k5.exact_checks",
     "k3.contact_steps"), 0)
NEW = ("transfer_mb.solo", "transfer_mb.batched",
       "exact_checks_per_kstep.solo", "contact_steps_per_ksimstep.batched",
       "device_launches_per_kstep.batched")


def read(name, counters, monkeypatch, sims=1, steps=1024):
    monkeypatch.setattr(program_counters, "read", lambda: counters)
    return core.metric_reader(ROOT, name)(
        SimpleNamespace(sims=sims, steps=steps, calls=3))


def test_solo_readers(monkeypatch):
    """Five calls of 1,024 steps: tier 1 served 4,000, the contact tier
    the rest."""
    c = dict(ZERO, **{"transfer.h2d_bytes": 3_000_000,
                      "transfer.d2h_bytes": 2_000_000, "steps.tier1": 4000,
                      "steps.contact_tier": 1120, "k5.exact_checks": 1000,
                      "device.launches": 20})
    assert read("transfer_mb.solo", c, monkeypatch) == pytest.approx(1.0)
    assert read("exact_checks_per_kstep.solo", c,
                monkeypatch) == pytest.approx(250.0)
    assert read("device_launches_per_kstep.batched", c,
                monkeypatch) == pytest.approx(20e3 / 5120)


def test_batched_readers(monkeypatch):
    """Two calls of 64 sims x 1,024 steps on batched kernel 3."""
    sim_steps = 2 * 64 * 1024
    c = dict(ZERO, **{"transfer.h2d_bytes": 150_000_000,
                      "transfer.d2h_bytes": 50_000_000,
                      "sim_steps.batched_resident": sim_steps,
                      "k3.contact_steps": 512, "device.launches": 2 * 6153})
    assert read("transfer_mb.batched", c, monkeypatch,
                sims=64) == pytest.approx(100.0)
    assert read("contact_steps_per_ksimstep.batched", c,
                monkeypatch, sims=64) == pytest.approx(512e3 / sim_steps)
    assert read("device_launches_per_kstep.batched", c, monkeypatch,
                sims=64) == pytest.approx(6153e3 / 1024)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(name, monkeypatch):
    """A program without the registry (the parent's) or a cell whose route
    served nothing the metric counts reads None, and nothing raises."""
    assert read(name, None, monkeypatch) is None
    assert read(name, dict(ZERO), monkeypatch) is None


def test_a_traced_run_reports_them(tmp_path):
    """A traced run of the serve cell at test size (100 vertices, float64
    state) in a process of its own: five (100, 3) float64 arrays cross a
    call, and tier 1 serves every step of the ring-down."""
    root = tiny_root(tmp_path)
    code = ("import json, sys; from pathlib import Path; "
            "from portbench import core; "
            f"r = core.run(Path({str(root)!r}), 'cloth120.serve', "
            "2 ** 31 + 77, 0.3, True, device='cpu'); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    assert metrics["transfer_mb.solo"] == pytest.approx(5 * 100 * 3 * 8 / 1e6)
    assert metrics["exact_checks_per_kstep.solo"] >= 0.0
    assert "device_launches_per_kstep.batched" not in metrics
