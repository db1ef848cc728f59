"""On-mesh accuracy report: the reduced replay against the full-order run,
a CSV and jet heat maps.

Counterpart of ``scripts/accuracy_report.py``, on the port's own flow
(``bases/pipeline.py``): the bench scene (``bench.py``'s 120x120
procedural cloth, hung 20 units up from its pinned top cap) recorded for
``FOM_FRAMES`` frames, its bases at bench.py's constants, the reduced
solver replaying the recorded window (``run_steps(len(traj),
record=True)``: kernel 1, one launch a frame, on the card).  Writes
``on_mesh_accuracy.csv``, the rel-L2 and normal-angle heat maps of the
first, middle and last frames and a rotating capture of the last replayed
frame (matplotlib), and prints one JSON line with the mean errors; a mean
past the committed gates raises after the line is printed.

On the card the replay runs float32 state with bfloat16 matrices, as the
JAX script's device branch does; ``--cpu`` runs everything on the CPU in
float64::

    python -m animsnapbases_tpu_torch.analysis.accuracy_report [--cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile

import numpy as np

# the JAX script's acceptance gates: 2x the mean rel-L2 (3.071e-3) and
# mean normal angle (0.0989 rad) of an earlier replay, so that a change
# that doubles the on-mesh error fails the report
REL_L2_GATE = 6.2e-3
NORMAL_ANGLE_GATE = 0.20

# bench.py's constants (its scene without a mesh file:
# ``bases/pipeline.bench_model`` at CLOTH_ROWS x CLOTH_ROWS vertices)
CLOTH_ROWS = 120
FOM_FRAMES = 48
FOM_ITERS = 10
POS_MODES = 64
CONSTR_MODES = 40
SERVED_MODES = 30
DT = 0.016
DAMPING = 2e-3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_model():
    """bench.py's scene at CLOTH_ROWS x CLOTH_ROWS vertices
    (``bases/pipeline.bench_model``)."""
    from animsnapbases_tpu_torch.bases.pipeline import bench_model as scene

    return scene(CLOTH_ROWS)


def check_gates(mean_l2: float, mean_ang: float) -> dict:
    """Gate fields for the JSON line; raises on a gate violation."""
    gates = {
        "rel_l2_gate": REL_L2_GATE,
        "normal_angle_gate_rad": NORMAL_ANGLE_GATE,
        "gate_passed": bool(mean_l2 <= REL_L2_GATE
                            and mean_ang <= NORMAL_ANGLE_GATE),
    }
    if not gates["gate_passed"]:
        raise AssertionError(
            f"on-mesh accuracy regressed past the committed gate: "
            f"mean rel-L2 {mean_l2:.3e} (gate {REL_L2_GATE:.3e}), "
            f"mean normal angle {mean_ang:.3e} rad "
            f"(gate {NORMAL_ANGLE_GATE:.3e})")
    return gates


def report(traj_full, traj_red, faces, out_dir: str, draw: bool = True,
           emit=print) -> dict:
    """The report on a full-order trajectory and its reduced replay ((F,
    N, 3) each): the CSV under ``out_dir``, with ``draw`` the heat maps
    and the rotating capture, then the JSON line through ``emit`` ->
    {"line": the JSON object, "rows": the CSV rows, "rel_l2",
    "normal_angle": the per-vertex maps (F, N)}.  A mean past a gate
    raises ``AssertionError`` after the line is emitted (its
    ``gate_passed`` false)."""
    from animsnapbases_tpu_torch.analysis.accuracy import (
        compute_accuracy_arrays,
        render_error_heatmaps,
    )

    traj_full = np.asarray(traj_full)
    traj_red = np.asarray(traj_red)
    rows, l2_maps, ang_maps = compute_accuracy_arrays(traj_full, traj_red,
                                                      faces)
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "on_mesh_accuracy.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["frame", "rel_l2",
                                          "normal_angle"])
        w.writeheader()
        w.writerows(rows)

    F = len(traj_full)
    pngs, rot = [], []
    if draw:
        from animsnapbases_tpu_torch.analysis.viewer import (
            view_rotating_capture,
        )

        sel = sorted({0, F // 2, F - 1})
        pngs = render_error_heatmaps(traj_red, faces, l2_maps, out_dir, sel,
                                     prefix="rel_l2")
        pngs += render_error_heatmaps(traj_red, faces, ang_maps, out_dir,
                                      sel, prefix="normal_angle")
        # multi-angle views of the last replayed frame beside the heat maps
        rot = view_rotating_capture(traj_red[-1], faces,
                                    os.path.join(out_dir, "rotation"),
                                    num_frames=8, prefix="replay_final")
        pngs += rot
    log(f"[accuracy] wrote {csv_path}, {len(pngs) - len(rot)} heat maps and "
        f"{len(rot)} rotation captures")

    mean_l2 = float(np.mean([r["rel_l2"] for r in rows]))
    mean_ang = float(np.mean([r["normal_angle"] for r in rows]))
    line = {}
    try:
        gates = check_gates(mean_l2, mean_ang)
    except AssertionError:
        gates = {"rel_l2_gate": REL_L2_GATE,
                 "normal_angle_gate_rad": NORMAL_ANGLE_GATE,
                 "gate_passed": False}
        raise
    finally:
        line.update({
            "metric": "on_mesh_accuracy_mean_rel_l2",
            "value": round(mean_l2, 6),
            "unit": "relative L2",
            # headroom under the committed gate (>= 1 passes)
            "vs_baseline": round(REL_L2_GATE / max(mean_l2, 1e-30), 3),
            "detail": {"mean_normal_angle_rad": round(mean_ang, 5),
                       "frames": F, "csv": csv_path,
                       "heatmaps": [os.path.basename(p) for p in pngs],
                       **gates},
        })
        emit(json.dumps(line))
    return {"line": line, "rows": rows, "rel_l2": l2_maps,
            "normal_angle": ang_maps}


def replay(solver, model, frames: int) -> np.ndarray:
    """The reduced replay of the recorded window from the model's state:
    ``run_steps(frames, record=True)`` under gravity -> (frames, N, 3)."""
    from animsnapbases_tpu_torch.bases.pipeline import gravity

    return solver.run_steps(gravity(model), frames,
                            num_iterations=FOM_ITERS, record=True)


def main(argv=None):
    import torch

    from animsnapbases_tpu_torch.bases.pipeline import (
        build_bases,
        gravity,
        record_fom,
        reduced_args,
    )
    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="record, build and replay on the CPU in float64 "
                         "(default: the card, float32 state and bfloat16 "
                         "matrices)")
    ap.add_argument("--out", default=os.path.join("output", "accuracy"))
    args = ap.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    if dev.type == "cuda":
        dtype, mm = torch.float32, torch.bfloat16
    else:
        dtype = mm = torch.float64
    log(f"[accuracy] device={dev} state {dtype} matrices {mm}")
    model = bench_model()
    f = gravity(model)
    with tempfile.TemporaryDirectory() as work:
        record = os.path.join(work, "FOM")
        traj_full, _ = record_fom(bench_model(), f, record, FOM_FRAMES,
                                  FOM_ITERS, DT, DAMPING, device=dev)
        basis_dir, pos_path, _ = build_bases(
            model, record, traj_full, work, CONSTR_MODES, POS_MODES,
            device=dev)
        sim_args = reduced_args(basis_dir, pos_path,
                                min(SERVED_MODES, CONSTR_MODES), POS_MODES,
                                DT, DAMPING)
        solver = AnimSnapBasesSolver(sim_args, device=dev, dtype=dtype,
                                     matmul_dtype=mm)
        solver.resident_contact_mode = False
        solver.set_model(model)
        solver.prepare(sim_args)
        traj_red = replay(solver, model, len(traj_full))
    report(traj_full, traj_red, model.faces, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
