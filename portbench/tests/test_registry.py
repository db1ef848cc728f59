"""Configurations, traffic mixes and metrics are found by name, and a new
one of each is added by files and entries alone."""

import json

import numpy as np

from portbench import core
from portbench.tests.tiny import ROOT, tiny_root
from portbench.reference.scene import FLOOR_HEIGHT
from portbench.traffic import Requests, Traffic
from portbench.traffic import load as load_traffic


def test_every_cell_finds_its_pieces():
    spec = core.load_spec(ROOT)
    assert {w["name"] for w in spec["workloads"]} == {
        "cloth120.serve", "bar40.serve", "cloth120.ensemble64"}
    for w in spec["workloads"]:
        cfg = core.load_config(ROOT, spec, w["config"])
        assert cfg["name"] == w["config"]
        load_traffic(ROOT, w["traffic"])
        assert core.load_limits(ROOT, w["name"])
        for trace in (False, True):
            for m in core.cell_metrics(spec, w["name"], trace):
                assert callable(core.metric_reader(ROOT, m["name"]))
        moved = {m["moves"] for m in core.cell_metrics(spec, w["name"], True)}
        e2e = {m["name"] for m in core.cell_metrics(spec, w["name"], False)}
        assert moved <= e2e and "setup_s" in e2e and len(e2e) >= 2


def test_a_new_cell_takes_files_and_entries_only(tmp_path):
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/cloth120_strain_spring.json")
                     .read_text())
    cfg.update(name="dummy_cloth")
    cfg["scene"]["rows"] = 8
    (root / "portbench/configs/dummy_cloth.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps({
        "entry": "run_steps", "steps": 6, "sims": 1,
        "start": {"kind": "rest"},
        "velocity": {"kind": "tail", "factor": 0.2, "scale": [1.0, 2.0]},
        "force": "none", "strata": 4, "samples": 2}))
    (root / "portbench/metrics/dummy_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx.calls\n")
    (root / "portbench/limits/dummy.cell.json").write_text(json.dumps(
        {"pos_gap": {"limit": 1e-4}}))
    spec["configs"].append({"name": "dummy_cloth", "source": "test",
                            "file": "portbench/configs/dummy_cloth.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cloth",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("dummy.cell")
    spec["per_layer"].append({"name": "dummy_metric", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "steps_per_s",
                              "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = core.run(root, "dummy.cell", 5, 0.2, False, device="cpu")
    assert res["correct"], res["checks"]
    assert {"steps_per_s", "rollout_p95_ms", "setup_s"} <= set(res["metrics"])
    res = core.run(root, "dummy.cell", 6, 0.2, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_metric"]["value"] == 2.0 * res["attempted"]


def test_traffic_is_stratified_and_seeded():
    spec = load_traffic(ROOT, "ringdown")
    a, b = Traffic(spec, 2 ** 31 + 12345), Traffic(spec, 7)
    n = spec["strata"]
    sa = sorted(float(a.params(i)["scale"][0]) for i in range(n))
    sb = sorted(float(b.params(i)["scale"][0]) for i in range(n))
    lo, hi = spec["velocity"]["scale"]
    width = (hi - lo) / n
    assert [int((s - lo) // width) for s in sa] == list(range(n))
    assert [int((s - lo) // width) for s in sb] == list(range(n))
    assert sa != sb
    assert a.params(3) == Traffic(spec, 2 ** 31 + 12345).params(3)
    ens = Traffic(load_traffic(ROOT, "ensemble64_low"), 99)
    scales = np.sort(ens.params(0)["scale"])
    assert np.all(np.diff([int((s - lo) // ((hi - lo) / 64))
                           for s in scales]) == 1)


def test_requests_are_remade_alike():
    """A request's inputs depend on the seed and its number alone, also
    when the generator's arrays were written by other requests between."""
    rng = np.random.default_rng(0)
    pos, tail = rng.random((30, 3)), rng.random((30, 3))
    mass = np.ones(30)
    spec = {"entry": "make_batched_run", "steps": 4, "sims": 6,
            "start": {"kind": "floor_gap", "gap": [0.02, 0.2],
                      "speed": [1.0, 3.0]},
            "velocity": {"kind": "none"}, "force": "gravity", "strata": 4,
            "samples": 2}
    for velocity in ({"kind": "none"},
                     {"kind": "tail", "factor": 0.1, "scale": [0.5, 1.5]}):
        spec["velocity"] = velocity
        req = Requests(Traffic(spec, 2 ** 31 + 3), pos, mass, tail)
        first = [x.copy() for x in req(5)]
        req(2)
        again = req(5)
        for x, y in zip(first, again):
            np.testing.assert_array_equal(x, y)
        P, V, F = again
        gap = P[:, :, 1].min(axis=1) - FLOOR_HEIGHT
        assert np.all((gap >= 0.02) & (gap <= 0.2))
        if velocity["kind"] == "none":
            assert np.all((V[..., 1] <= -1.0) & (V[..., 1] >= -3.0))
        assert np.all(F[..., 1] == -9.81)
