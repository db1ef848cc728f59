"""Material system identification: recover per-group constraint weights
from a recorded trajectory by gradient descent through the reduced
simulator (``sim/diff.py``).

Counterpart of ``scripts/fit_material.py``, on the port's own pipeline
(``bases/pipeline.py``: the full-order recording, the product bases, the
reduced solver's arguments).  A twin experiment: a pinned cloth is
recorded full order and reduced; a "measured" trajectory is simulated with
changed tri-strain and edge-spring weights; the scales are re-fitted from
ones with Adam on the mean squared position error.  Recorded bases matter:
with random bases the weight-response map of the hyper-reduced system is
chaotic and the loss has no usable basin.

The default scene is the 8x8 cloth of the JAX script.  ``--bench`` fits on
the bench scene (bench.py's 120x120 procedural cloth, 14,400 vertices) and
its recorded bases, as the JAX script's ``--bunny`` does on hosts without
the reference mesh.  Prints one JSON line with the true and fitted scales
and the loss drop, exits 1 when the fit does not converge (largest relative
error 0.1 or more, or a loss drop short of 1e3).  Runs on the card in
float64 unless ``--cpu``::

    python -m animsnapbases_tpu_torch.demos.fit_material [--bench] [--cpu]
        [--steps N] [--horizon T] [--lr LR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from animsnapbases_tpu_torch.bases.pipeline import bench_model, gravity

DT = 0.016
DAMPING = 0.02      # keeps the under-iterated rollout contractive
ITERS = 6           # iterations of each fitted step
# the twin experiment (scripts/fit_material.py's default mode)
TWIN = dict(frames=30, fom_iters=6, fom_damping=DAMPING, constr_modes=10,
            pos_modes=14, modes=10, oversample=1.0,
            true={"edge_spring": 1.6, "tris_strain": 0.55},
            defaults=(150, 16, 0.08))
# the bench scene (bench.py's recording and bases: 48 frames at 10
# iterations, 40 constraint modes, position modes 64 clipped to the 48
# frames; its --bunny fit: 30 modes a group, DEIM oversampled 4/3)
BENCH = dict(frames=48, fom_iters=10, fom_damping=2e-3, constr_modes=40,
             pos_modes=64, modes=30, oversample=4.0 / 3.0,
             true={"tris_strain": 0.5, "edge_spring": 2.0},
             defaults=(250, 12, 0.05))


def twin_model():
    """The JAX script's cloth: 8x8, z += 0.15 sin x, masses 10, floor off,
    edge springs and tri strain (0.95-1.05) at wi = 1e4, left side pinned
    by mass."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    V, F = cloth_model(8, 8)
    V = V.copy()
    V[:, 2] += 0.15 * np.sin(V[:, 0])
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=False)
    model.add_edge_spring_constraint(wi=1e4)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


def record_and_bases(make_model, cfg: dict, work: str, device):
    """The full-order recording of ``make_model()`` under gravity and its
    bases (``bases/pipeline.py`` ``record_fom``, ``build_bases``) under
    ``work`` -> (basis_dir, pos_path)."""
    from animsnapbases_tpu_torch.bases.pipeline import build_bases, record_fom

    model = make_model()
    record = os.path.join(work, "FOM")
    traj, _ = record_fom(model, gravity(model), record, cfg["frames"],
                         cfg["fom_iters"], DT, cfg["fom_damping"],
                         device=device)
    basis_dir, pos_path, _ = build_bases(
        make_model(), record, traj, work, cfg["constr_modes"],
        cfg["pos_modes"], device=device)
    return basis_dir, pos_path


def diff_sim(make_model, cfg: dict, basis_dir: str, pos_path: str, device):
    """The reduced solver of the recorded bases (``reduced_args`` at
    ``cfg["modes"]`` modes a group, damping DAMPING), prepared on
    ``device``, and its differentiable view -> (sim, model)."""
    from animsnapbases_tpu_torch.bases.pipeline import reduced_args
    from animsnapbases_tpu_torch.sim.diff import DiffReducedSim
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    args = reduced_args(basis_dir, pos_path, cfg["modes"], cfg["pos_modes"],
                        DT, DAMPING, oversample=cfg["oversample"])
    solver = AnimSnapBasesSolver(args, device=device)
    model = make_model()
    solver.set_model(model)
    solver.prepare(args)
    return DiffReducedSim(solver), model


def fit(sim, model, cfg: dict, steps: int, horizon: int, lr: float):
    """The twin experiment on ``sim``: the trajectory of ``horizon`` steps
    with the true scales from the model's state under gravity, then
    ``fit_scales`` from ones -> (detail dict, ok)."""
    import torch

    from animsnapbases_tpu_torch.sim.diff import fit_scales

    true_s = np.array([cfg["true"].get(n, 1.0) for n in sim.group_names])
    t = sim.tensor
    q0, v0 = t(model.positions), t(model.velocities)
    fext = t(gravity(model))
    targets = t(model.positional_targets(0))[None]
    rollout = sim.make_rollout(horizon, num_iterations=ITERS,
                               save_trajectory=True)
    with torch.no_grad():
        target_traj = rollout(q0, v0, fext, targets, t(true_s))[2]
    if not bool(torch.isfinite(target_traj).all()):
        raise RuntimeError("the true-scale trajectory is not finite")
    t0 = time.perf_counter()
    fitted, history = fit_scales(
        sim, q0, v0, fext, targets, target_traj, num_iterations=ITERS,
        steps=steps, learning_rate=lr, log_every=max(1, steps // 10))
    wall = time.perf_counter() - t0
    fitted = fitted.cpu().numpy()
    err = {name: abs(float(fitted[i]) - true_s[i]) / true_s[i]
           for i, name in enumerate(sim.group_names)}
    detail = {
        "device": str(sim.device), "n_verts": sim.n_verts, "r": sim.r,
        "groups": sim.group_names,
        "true_scales": [float(x) for x in true_s],
        "fitted_scales": [float(x) for x in fitted],
        "rel_err": err, "loss_first": history[0], "loss_last": history[-1],
        "adam_steps": steps, "horizon": horizon, "wallclock_s": wall,
        "ms_per_adam_step": 1e3 * wall / max(steps, 1),
    }
    ok = max(err.values()) < 0.1 and history[-1] < 1e-3 * history[0]
    return detail, ok


def run(bench: bool, device, steps=None, horizon=None, lr=None):
    """One experiment end to end (record, bases, reduced solver, fit) in a
    temporary directory -> (the JSON record the script prints, ok)."""
    cfg = BENCH if bench else TWIN
    make_model = bench_model if bench else twin_model
    d_steps, d_horizon, d_lr = cfg["defaults"]
    steps = d_steps if steps is None else steps
    horizon = d_horizon if horizon is None else horizon
    lr = d_lr if lr is None else lr
    with tempfile.TemporaryDirectory(prefix="fit_material_") as work:
        t0 = time.perf_counter()
        basis_dir, pos_path = record_and_bases(make_model, cfg, work, device)
        bases_s = time.perf_counter() - t0
        sim, model = diff_sim(make_model, cfg, basis_dir, pos_path, device)
        detail, ok = fit(sim, model, cfg, steps, horizon, lr)
    detail["record_and_bases_s"] = bases_s
    detail["bases"] = (f"recorded ({cfg['frames']} frames; pod_vectorized + "
                       f"row DEIM, {cfg['modes']} modes a group, r = "
                       f"{sim.r})")
    data = {
        "metric": ("material_fit_max_rel_scale_error_bench" if bench
                   else "material_fit_max_rel_scale_error"),
        "value": max(detail["rel_err"].values()),
        "unit": "relative",
        "vs_baseline": 1.0,
        "detail": detail,
    }
    return data, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true",
                    help="fit on the bench scene (14,400 vertices) and its "
                         "recorded bases")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (float64) instead of the card")
    ap.add_argument("--steps", type=int, default=None, help="Adam steps")
    ap.add_argument("--horizon", type=int, default=None,
                    help="fitted trajectory length (steps)")
    ap.add_argument("--lr", type=float, default=None)
    args = ap.parse_args(argv)

    from animsnapbases_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    data, ok = run(args.bench, device, args.steps, args.horizon, args.lr)
    print(json.dumps(data))
    if not ok:
        print("FIT DID NOT CONVERGE", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
