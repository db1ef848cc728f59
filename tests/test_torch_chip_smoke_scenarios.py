"""``chip_smoke.scenarios_phase`` (phase [11]: the reference's loop through
the port's command lines and the analysis) rehearsed on the CPU with the
fakes of ``tests/test_torch_chip_smoke.py`` at its smallest sizes: phase
[6]'s recording and bases of the 14x14 cloth in a shared directory, then
(a) the event demo on an 8x8 cloth for 26 frames (the event at frame 20
crossed) through ``sim_cli``, ``cli.main`` on the three example configs
at 10 frames and 6 components, the replay through ``sim_cli`` and the
accuracy CSV, (b) the same fully reduced on kernel 1's plain version
(r = 8), prepared again at the event, each prepare's frames held against
the CPU's float64 and float32 runs, (c) the accuracy report on phase
[6]'s files with bfloat16 and float32 matrices (float64 here: the CPU),
and kernel 1's entries under ``scenarios``."""

import json
import os
import tempfile

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    KEYS,
    one_thread,
    rehearsal,
)

SMALL = {"SCEN_SYSTEM": {"cloth_width": 8, "cloth_height": 8},
         "SCEN_FRAMES": 26, "SCEN_POS_MODES": 8,
         "SCEN_OVERRIDES": {"numFrames": 10, "desired_num_components": 6}}


def test_chip_smoke_scenarios_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        cs.pipeline_phase(torch, counted, paths, dev, work=work)
        out = cs.scenarios_phase(torch, counted, paths, dev, "cpu, 0 W",
                                 work)
    assert sorted(out) == ["fused_reduced_iterations"]
    scen = out["fused_reduced_iterations"]
    b = scen["event_demo_reduced"]
    entries = [b] + [scen["accuracy_report"][m]
                     for m in ("bfloat16", "float32")]
    for entry in entries:
        assert KEYS - {"name", "route", "source", "replaces"} <= set(entry)
        assert entry["bound_ms"] > 0
        # the plain versions count no launch
        assert entry["launches"] == paths[entry["launches_path"]][
            "fused_reduced_iterations"]
    assert b["frames"] == 26 and b["r"] == 8 and b["finite"]
    assert [s["frames"] for s in b["segments"]] == [[0, 20], [20, 26]]
    assert all(s["cond_Ar"] > 1 for s in b["segments"])
    # each prepare's frames through the CPU's float64 and float32 runs
    assert sorted(b["event_holds"]) == [0, 20]
    assert all(h["ok"] for h in b["event_holds"].values())
    assert [s["frames"] for s in b["cpu_float64_segments"]] == [[0, 20],
                                                                [20, 26]]
    for m in ("bfloat16", "float32"):
        assert scen["accuracy_report"][m]["gate_passed"]
    holds = scen["event_demo_full"]["holds"]
    assert list(holds["record"]) == [20] and list(holds["replay"]) == [20]
    assert max(holds["record"].values()) <= cs.CPU_DEVIATION
    assert sorted(holds["bases"]) == sorted(cs.CLOTH_KINDS)
    text = capsys.readouterr().out
    for line in ("[11] scenarios, (a) cloth_automated_bend_spring_strain",
                 "recorded by sim_cli", "(a) cli.main on cloth_automated_"
                 "deim_triStrainSubspace.json", "figures drawn",
                 "the CSV against the in-memory trajectories",
                 "(a) recording: at each event the card's state",
                 "(a) replay: at each event", "(b) fully reduced",
                 "(b) per frame rel-L2", "(b): at each prepare the card's "
                 "state", "(b) the same replay on the CPU in float64",
                 "kernel 1 on the first step after "
                 "the prepare at frame 20", "(c) accuracy report, bfloat16 "
                 "matrices: {", "[11] scenarios seconds (cpu, 0 W)"):
        assert line in text, line
    report = [ln for ln in text.splitlines()
              if ln.startswith("[11] scenarios, (c) accuracy report, "
                               "float32 matrices: ")][0]
    line = json.loads(report.split("matrices: ", 1)[1])
    assert line["metric"] == "on_mesh_accuracy_mean_rel_l2"
    assert line["detail"]["frames"] == cs.FOM_FRAMES
