"""``chip_smoke.multichip_phase`` (phase [12]: the sharded paths on ranks
of one card, the smoke battery and the sweep, the native reader) rehearsed
on the CPU at its smallest sizes with the fakes of
``tests/test_torch_chip_smoke.py``: the 14x14 bench cloth's main path,
phase [6]'s recording and bases, phase [11]'s demo on an 8x8 cloth for 26
frames with example configs of 10 frames and 6 components, then (a) two
gloo ranks on the CPU (the ring-down ensemble of 4 sims on both routes,
the mixed batch, the TP-reduced and element-sharded steps, the sharded
POD and constraint bases), (b) the battery's nine PASS lines (faked: its
checks are rehearsed in tests/test_torch_smoke.py) and the sweep's three
workers on the CPU, (c) the native reader."""

import tempfile

import torch

import chip_smoke as cs
from test_torch_chip_smoke import bench, one_thread  # noqa: F401
from test_torch_chip_smoke_scenarios import SMALL


def test_chip_smoke_multichip_phase(monkeypatch, capsys):
    counted, b = bench(monkeypatch)
    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "MC_POD", (2_001, 16))
    paths = {}
    with tempfile.TemporaryDirectory() as shared:
        cs.pipeline_phase(torch, counted, paths, b.dev, work=shared)
        cs.scenarios_phase(torch, counted, paths, b.dev, "cpu, 0 W", shared)
        out = cs.multichip_phase(torch, b.dev, "cpu, 0 W", shared, b.solver,
                                 b.main_state,
                                 cs.battery_result(cs.start_battery()))
    a = out["sharded"]
    assert sorted(a["serving"]) == ["chunked", "chunked_mixed", "resident"]
    n = cs.MC_RANKS
    for key, sims in (("resident", cs.ENSEMBLE), ("chunked", cs.ENSEMBLE),
                      ("chunked_mixed", cs.MIXED)):
        s = a["serving"][key]
        kind = "resident" if key == "resident" else "chunked"
        assert s["path"].startswith(f"batched-{kind}-sharded[{n}x"
                                    f"{sims // n}]")
        assert s["rule"] == "bit for bit"
        assert len(s["us_per_step_per_rank"]) == n
    assert a["tp"]["as_accurate"] and a["tp"]["vs_step_ok"]
    assert a["pod"]["within_bounds"]
    assert a["element"]["max_abs"] <= cs.MC_FOM_TOL * a["element"]["extent"]
    assert sorted(a["bases"]) == ["edge_spring", "tris_strain"]
    assert all(g["same_basis_picks_equal"] and g["within_bounds"]
               and g["unsharded_agree"] for g in a["bases"].values())
    bs = out["battery_and_sweep"]
    assert len(bs["battery"]) == 9
    assert sorted(bs["sweep"]) == sorted(cs.CLOTH_KINDS)
    assert out["native"]["off_frames"] == 26
    text = capsys.readouterr().out
    for line in ("[12] (a) sharded serving, resident", "[12] (a) TP-reduced",
                 "[12] (a) element-sharded FOM step", "[12] (a) sharded POD",
                 "[12] (a) tris_strain bases", "[12] (b) smoke battery",
                 "[12] (b) sweep of 3 configs", "[12] (c) native I/O"):
        assert line in text, line
