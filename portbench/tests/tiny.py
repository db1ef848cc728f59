"""A checkout root at test sizes: the benchmark's files (configurations,
mixes, readers, constraint and scene kinds) with every cloth at 10 x 10,
the bar at 8 x 3 x 3, short rollouts and small ensembles, a precision of
the test's choosing, and the numbers each cell's committed limits compare
held to a limit of the test's choosing."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, state="float64", matrices="float64", steps=12,
              limit=1e-4) -> Path:
    tmp = Path(tmp)
    pb = tmp / "portbench"
    pb.mkdir(parents=True)
    for d in ("traffic", "metrics", "configs", "reference/kinds",
              "reference/scenes"):
        shutil.copytree(ROOT / "portbench" / d, pb / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "limits").mkdir()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        if cfg["scene"]["kind"] == "cloth":
            cfg["scene"]["rows"] = 10
        else:
            cfg["scene"]["size"] = [8, 3, 3]
            cfg["recording"]["frames"] = 40
            cfg["bases"].update(frames=20, modes=20)
            cfg["served"]["modes"] = 12
            cfg["served"]["position_modes"] = 8
        cfg["precision"] = {"state": state, "matrices": matrices}
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for f in (pb / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["steps"] = steps
        if t["sims"] > 1:
            t.update(sims=8, strata=8)
        f.write_text(json.dumps(t))
    for w in spec["workloads"]:
        # the numbers the committed limits compare, at the test's limit
        committed = ROOT / "portbench" / "limits" / f"{w['name']}.json"
        names = (list(json.loads(committed.read_text()))
                 if committed.exists() else ["pos_gap", "vel_gap"])
        (pb / "limits" / f"{w['name']}.json").write_text(json.dumps(
            {n: {"limit": limit} for n in names}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
