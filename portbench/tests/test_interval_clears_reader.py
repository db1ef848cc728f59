"""The reader of kernel 5's interval-bound counter
(``portbench/metrics/interval_clears_per_kstep.py``): on hand-made
counters, on a program that lacks the counter or the whole registry, and
from a traced run of the serve cell at test size in a process of its own,
through ``portbench/run.py``."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import core, program_counters
from portbench.tests.tiny import ROOT, tiny_root

NAME = "interval_clears_per_kstep.solo"
ZERO = dict.fromkeys(
    ("transfer.h2d_bytes", "transfer.d2h_bytes", "steps.tier1",
     "steps.contact_tier", "steps.kernel1", "sim_steps.batched_resident",
     "sim_steps.batched_chunked", "device.launches", "k5.exact_checks",
     "k5.interval_clears", "k3.contact_steps"), 0)


def read(name, counters, monkeypatch):
    monkeypatch.setattr(program_counters, "read", lambda: counters)
    return core.metric_reader(ROOT, name)(
        SimpleNamespace(sims=1, steps=1024, calls=3))


def test_interval_clears_reader(monkeypatch):
    """Tier 1 served 4,000 steps, on 1,680 of which the interval bound
    cleared the floor after the Cauchy-Schwarz bound tripped: 420 per
    1,000 steps of ``steps.tier1``; a program whose registry has no
    ``k5.interval_clears`` (one without the interval bound) reads None,
    and the exact checks still read."""
    c = dict(ZERO, **{"steps.tier1": 4000, "steps.contact_tier": 1120,
                      "k5.exact_checks": 12, "k5.interval_clears": 1680})
    assert read(NAME, c, monkeypatch) == pytest.approx(420.0)
    older = {k: v for k, v in c.items() if k != "k5.interval_clears"}
    assert read(NAME, older, monkeypatch) is None
    assert read("exact_checks_per_kstep.solo", older,
                monkeypatch) == pytest.approx(3.0)


@pytest.mark.parametrize("counters", [None, dict(ZERO)],
                         ids=["no_registry", "no_tier1_steps"])
def test_nothing_to_read(counters, monkeypatch):
    """A program without the registry or a cell whose route served no
    tier-1 step reads None, and nothing raises."""
    assert read(NAME, counters, monkeypatch) is None


def test_a_traced_run_reports_it(tmp_path):
    """A traced run of the serve cell at test size (100 vertices, float64
    state) in a process of its own reports the metric."""
    root = tiny_root(tmp_path)
    code = ("import json, sys; from pathlib import Path; "
            "from portbench import core; "
            f"r = core.run(Path({str(root)!r}), 'cloth120.serve', "
            "2 ** 31 + 79, 0.3, True, device='cpu'); "
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    assert metrics[NAME] >= 0.0
