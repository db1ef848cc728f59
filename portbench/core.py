"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration's file, ``portbench/traffic/<mix>.json``,
``portbench/metrics/<metric>.py`` (a ``read(ctx)`` that returns a number
or None; ``<quantity>.py`` serves the parts ``<quantity>.<part>``) and
``portbench/limits/<cell>.json`` (the limit of each number the check
compares).  From the program (``animsnapbases_tpu_torch``) the
run takes the system under test, its launch counters and the names of its
kernels; the bases, the inputs and the reference are the benchmark's own.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench.reference import bases as bases_maker
from portbench.reference.scene import build_scene, kind_module, per_group
from portbench.traffic import Requests, Traffic
from portbench.traffic import load as load_traffic
from portbench.tracing import CALL, INPUTS, WINDOW, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "animsnapbases_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# finding the pieces of a cell by name
# ----------------------------------------------------------------------

def load_spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r}")


def load_config(root: Path, spec: dict, name: str) -> dict:
    entry = find(spec["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def load_limits(root: Path, cell: str) -> dict:
    path = Path(root) / "portbench" / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def metric_reader(root: Path, name: str):
    """``read`` of ``portbench/metrics/<name>.py``; a metric split by the
    end-to-end metric it moves (``<quantity>.<part>``) without a file of
    its own reads ``<quantity>.py``."""
    folder = Path(root) / "portbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those that list it, or that list no
    cells and move an end-to-end metric it reports)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------------
# the program under test
# ----------------------------------------------------------------------

def launch_counters() -> dict:
    """Every launch counter of the program's kernel wrappers, by name."""
    from animsnapbases_tpu_torch.ops import (affine, affine_chunked,
                                             fused_reduced, resident)

    out = {}
    for mod in (fused_reduced, resident, affine, affine_chunked):
        for name, obj in vars(mod).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None),
                                            int):
                out[f"{mod.__name__.split('.')[-1]}.{name}"] = obj
    for i, c in enumerate(getattr(affine_chunked, "COUNTERS", ())):
        out[f"affine_chunked.COUNTERS[{i}]"] = c
    return out


def read_counters(counters: dict) -> dict:
    return {k: int(c.launches) for k, c in counters.items()}


def program_model(scene, cfg: dict):
    """The program's model of the scene: each group added as its kind's
    ``PROGRAM`` says, the scene's pins fixed."""
    from animsnapbases_tpu_torch.sim.model import DeformableModel

    model = DeformableModel(scene.positions, scene.faces,
                            elements=scene.tets, masses=scene.mass.copy(),
                            floor_collision=scene.floor,
                            init_height_shift=0.0)
    for name, g in cfg["groups"].items():
        prog = scene.groups[name].kind.PROGRAM
        getattr(model, prog["method"])(**{k: g[k] for k in prog["kwargs"]})
    for i in np.flatnonzero(scene.pinned):
        model.fix(int(i))
    return model


def program_args(cfg: dict, made: dict, root=None):
    """The program's arguments: each group reduced under its kind's
    program group name with its served modes."""
    from animsnapbases_tpu_torch.config.sim_config import default_sim_args
    from animsnapbases_tpu_torch.sim.reduced import GROUP_ARG_NAMES

    args = default_sim_args()
    args.dt = cfg["dt"]
    args.damping = cfg["damping"]
    args.constraint_projection_basis_type = "deim_pod_vectorized"
    served = cfg["served"]
    for name in cfg["groups"]:
        group = kind_module(name, root).PROGRAM["group"]
        flag, num = GROUP_ARG_NAMES[group]
        setattr(args, flag, True)
        setattr(args, num, per_group(served["modes"], name))
    args.deim_oversample = float(served["oversample"])
    args.geom_interpolation_basis_dir = made["dir"]
    args.geom_interpolation_basis_file = "basis.npz"
    args.position_reduced = True
    args.position_num_components = int(served["position_modes"])
    args.position_basis_file = made["pos"]
    return args


def program_solver(cfg: dict, args, device: str):
    import torch

    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    prec = cfg["precision"]
    dtype = getattr(torch, prec["state"])
    mm = getattr(torch, prec["matrices"])
    solver = AnimSnapBasesSolver(args, device=device, dtype=dtype,
                                 matmul_dtype=mm)
    for key, value in cfg.get("solver", {}).items():
        setattr(solver, key, value)
    return solver


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        control: str | None = None, hooks: dict | None = None) -> dict:
    """One run of ``cell`` -> the result's fields (see ``run.py``).
    ``hooks`` (tests): ``{"call": f(call) -> call}`` wraps the entry point
    as the window calls it."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device == "cuda"
    root = Path(root)
    spec = load_spec(root)
    wl = find(spec["workloads"], cell, "workload")
    cfg = load_config(root, spec, wl["config"])
    tspec = load_traffic(root, wl["traffic"])
    traffic = Traffic(tspec, seed)
    limits = load_limits(root, cell)
    metrics = cell_metrics(spec, cell, trace)
    hooks = hooks or {}

    t_run = time.perf_counter()
    made = bases_maker.make(cfg, log=log, root=root)
    scene = build_scene(cfg, root)
    inputs = Requests(traffic, scene.positions, scene.mass,
                      made["tail_velocity"])
    t_bases = time.perf_counter()

    if control is not None:
        return run_control(scene, cfg, made, traffic, inputs, limits,
                           device, control, seed)

    model = program_model(scene, cfg)
    args = program_args(cfg, made, root)
    solver = program_solver(cfg, args, device)
    solver.set_model(model)
    t0 = time.perf_counter()
    solver.prepare(args)
    prepare_s = time.perf_counter() - t0
    steps, iters = traffic.steps, int(cfg["iterations"])

    if traffic.batched:
        runner = solver.make_batched_run()

        def call(P0, V0, F):
            return runner(P0, V0, F, steps, num_iterations=iters)
    else:
        def call(P0, V0, F):
            model.positions, model.velocities = P0, V0
            solver.frame = 0
            solver.run_steps(F, steps, num_iterations=iters)
            return model.positions, model.velocities

    call = hooks.get("call", lambda c: c)(call)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # warm-up: one call of the cell's own shapes
    t_warm = time.perf_counter()
    call(*inputs(0))
    sync()
    t0 = time.perf_counter()
    log(f"portbench: bases {made['seconds']:.2f} s (0: cached), prepare "
        f"{prepare_s:.3f} s, warm call {t0 - t_warm:.3f} s")

    counters = launch_counters()
    tracer = Tracer(trace, cuda)
    tracer.start()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: set-up stages (s): start to run {t_run - t_start:.3f}, "
        f"bases and scene {t_bases - t_run:.3f}, model, solver and prepare "
        f"{t_warm - t_bases:.3f}, warm call {t0 - t_warm:.3f}, profiler "
        f"{t_start + setup_s - t0:.3f}")
    sims = traffic.sims
    sample = Sample(seed, sims, int(tspec["samples"]))
    before = read_counters(counters)
    latencies, failed, host = [], 0, [0.0, 0.0]
    w0 = time.perf_counter()
    with tracer.span(WINDOW):
        i = 0
        while True:
            h0 = time.perf_counter()
            with tracer.span(INPUTS):
                P0, V0, F = inputs(i)
            with tracer.span(CALL):
                c0 = time.perf_counter()
                out = call(P0, V0, F)
                sync()
                c1 = time.perf_counter()
            latencies.append(c1 - c0)
            failed += non_finite(out, sims)
            sample.add(i, *out)
            i += 1
            c2 = time.perf_counter()
            host[0] += c0 - h0
            host[1] += c2 - c1
            if c2 - w0 >= seconds:
                break
    window_s = time.perf_counter() - w0
    n_calls = len(latencies)
    log(f"portbench: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
        f"{n_calls} calls; the benchmark's host time in the window "
        f"{host[0]:.3f} s making inputs, {host[1]:.3f} s keeping answers")
    after = read_counters(counters)
    tracer.stop()
    t0 = time.perf_counter()
    summary = tracer.summary()
    if trace:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
        log(f"portbench: trace read in {time.perf_counter() - t0:.3f} s, "
            f"host peak resident {rss:.3f} GiB")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    kept = sample.close()
    picked = [ij for ij, _ in kept]
    served = [pv for _, pv in kept]
    del out, solver, model, kept, sample
    if traffic.batched:
        del runner
    if cuda:
        torch.cuda.empty_cache()

    checks, ref = judge(scene, cfg, made, traffic, inputs, picked, served,
                        limits, device)
    shape = cost_shape(scene, cfg, made)
    ctx = SimpleNamespace(
        root=root, cell=cell, cfg=cfg, traffic=tspec, trace=summary, setup_s=setup_s,
        prepare_s=prepare_s, window_s=window_s, calls=n_calls, sims=sims,
        steps=steps, latencies=latencies, launches=sum(after.values())
        - sum(before.values()), shape=shape,
        clamp_share=float(np.mean(ref["clamp_steps"])) / steps)
    values = {}
    for m in metrics:
        v = metric_reader(root, m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = failed == 0 and all(c["ok"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": n_calls * sims,
              "failed": failed, "metrics": values, "device":
              device_info(cuda, peak, summary if trace else None)}
    if trace and summary is not None:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in summary["device_ops"][:10]],
            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"][:10]]}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def device_info(cuda: bool, peak: int, summary) -> dict:
    if cuda:
        import torch

        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    if summary is not None:
        info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    return info


def non_finite(out, sims: int) -> int:
    """The sims of a call whose positions or velocities are not all
    finite: one sum a sim (a NaN or an infinity carries into it), in the
    array's own memory order, on torch's threads where the arrays are a
    batch's tens of megabytes."""
    import torch

    total = 0.0
    for x in out:
        x = np.asarray(x)
        x = x.reshape((sims,) + x.shape[-2:])
        total = total + (x.sum(axis=(1, 2)) if x.size < 1 << 20 else
                         torch.from_numpy(x).sum(dim=(1, 2)).numpy())
    return int((~np.isfinite(total)).sum())


class Sample:
    """``k`` answers of the window, (call, sim), drawn from the seed as the
    calls come: ``k - 1`` by reservoir sampling over the sims of every call
    but the last, and one sim of the window's last call, which is always
    among them.  Only the drawn sims' rows are kept."""

    def __init__(self, seed: int, sims: int, k: int):
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
        self.sims, self.m = sims, k - 1
        self.kept, self.pending, self.seen = [], None, 0

    def add(self, call: int, P=None, V=None):
        if self.pending is not None:
            self._feed(*self.pending)
        self.pending = (call, P, V)

    def _rows(self, P, V, j):
        if P is None:
            return None
        shape = (self.sims,) + np.shape(P)[-2:]
        return (np.array(np.reshape(P, shape)[j]),
                np.array(np.reshape(V, shape)[j]))

    def _feed(self, call, P, V):
        t = self.seen + np.arange(self.sims)
        draws = self.rng.integers(0, t + 1)
        for j in range(self.sims):
            if len(self.kept) < self.m:
                self.kept.append(((call, j), self._rows(P, V, j)))
            elif draws[j] < self.m:
                self.kept[draws[j]] = ((call, j), self._rows(P, V, j))
        self.seen += self.sims

    def close(self) -> list:
        """[((call, sim), (P, V) or None)], sorted by call and sim."""
        call, P, V = self.pending
        j = int(self.rng.integers(self.sims))
        return sorted(self.kept + [((call, j), self._rows(P, V, j))],
                      key=lambda e: e[0])


def judge(scene, cfg, made, traffic, inputs, sample, served, limits,
          device):
    """Run the float64 reference over the sampled answers' inputs and
    compare -> ({number: {"value", "limit", "ok"}}, reference output)."""
    from portbench.reference.reduced import ReducedReference

    t0 = time.perf_counter()
    P0, V0, F = stack_inputs(traffic, inputs, sample)
    ref = ReducedReference(scene, cfg, made["dir"], made["pos"],
                           device=device).rollout(P0, V0, F, traffic.steps)
    log(f"portbench: reference over {len(sample)} answers "
        f"{time.perf_counter() - t0:.3f} s")
    numbers = gaps(ref, served)
    checks = {}
    for name, value in numbers.items():
        if name in limits:
            lim = limits[name]["limit"]
            checks[name] = {"value": value, "limit": lim,
                            "ok": bool(value <= lim)}
        else:
            log(f"portbench reading {name}: {value!r} (not compared)")
    if not checks:
        checks["limits"] = {"value": 0, "limit": None, "ok": False}
    for name, c in checks.items():
        log(f"portbench check {name}: {c['value']!r} limit {c['limit']!r}")
    return checks, ref


def stack_inputs(traffic, inputs, sample):
    per = {}
    for c, j in sample:
        P, V, F = inputs(c)
        if traffic.batched:
            P, V, F = P[j], V[j], F[j]
        # the generator's arrays are overwritten by its next request
        per[(c, j)] = (P.copy(), V.copy(), F.copy())
    return tuple(np.stack([per[s][k] for s in sample]) for k in range(3))


def gaps(ref: dict, served) -> dict:
    """The numbers the check compares, each the largest over the sampled
    answers: ``pos_gap``, the largest entry of the final positions' gap
    from the reference's over the reference's largest displacement in the
    rollout, and ``vel_gap``, the same of the velocities over its largest
    speed."""
    out = {"pos_gap": 0.0, "vel_gap": 0.0}
    for s, (P, V) in enumerate(served):
        for name, X, Y, scale in (("pos_gap", P, ref["P"][s], ref["disp"][s]),
                                  ("vel_gap", V, ref["V"][s],
                                   ref["speed"][s])):
            v = float(np.abs(np.asarray(X, dtype=float) - Y).max() / scale)
            out[name] = max(out[name], v) if np.isfinite(v) else float(
                "inf")
    return out


def run_control(scene, cfg, made, traffic, inputs, limits, device, control,
                seed):
    """The control: the reference in ``control`` precision put in the
    program's place on as many answers as a run compares, judged as a
    run's are."""
    from portbench.reference.reduced import ReducedReference

    k = int(traffic.spec["samples"])
    draw = Sample(seed, traffic.sims, k)
    for c in range(-(-k // traffic.sims) + 1):
        draw.add(c)
    sample = [ij for ij, _ in draw.close()]
    P0, V0, F = stack_inputs(traffic, inputs, sample)
    out = ReducedReference(scene, cfg, made["dir"], made["pos"],
                           device=device, precision=control).rollout(
        P0, V0, F, traffic.steps)
    served = list(zip(out["P"], out["V"]))
    checks, _ = judge(scene, cfg, made, traffic, inputs, sample, served,
                      limits, device)
    correct = all(c["ok"] for c in checks.values())
    return {"correct": bool(correct), "attempted": len(sample), "failed": 0,
            "metrics": {}, "device": device_info(device == "cuda", 0, None),
            "checks": {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in checks.items()}}


def cost_shape(scene, cfg, made) -> dict:
    """The shapes the cost counts read: from the scene and the bases
    files, as the reference selects rows (``portbench/costs``)."""
    served = cfg["served"]
    rows, verts = {}, []
    for name, g in scene.groups.items():
        data = np.load(f"{made['dir']}/{name}/basis.npz")
        asked = per_group(served["modes"], name)
        ranges = data["interpol_alpha_ranges"]
        idx = min(int(round(asked * float(served["oversample"]))),
                  len(ranges))
        n_pt = int(ranges[idx - 1])
        rows[name] = n_pt
        alphas = data["interpol_alphas"][:n_pt].astype(np.int64)
        verts.append(g.kind.corners(g.data)[alphas].reshape(-1))
    mb = 2 if cfg["precision"]["matrices"] == "bfloat16" else 4
    return {"n": scene.n, "r": int(served["position_modes"]),
            "n_sel": int(len(np.unique(np.concatenate(verts)))),
            "rows": rows, "iterations": int(cfg["iterations"]),
            "matrix_bytes": mb}
