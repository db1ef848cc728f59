"""Kernel 5's floor test on one call of a benchmark cell, term by term.

    python3 tools/floor_bound_terms.py --workload cloth120.serve \
        --seed 3100000019 [--request 0] [--samples 16] [--out <file.json>]

from the root of a checkout, on the card.  It builds the cell's solver as
``portbench/run.py`` does (``portbench.core``), takes request
``--request`` of the seed, and serves it three ways from the same tensors:

* the kernel: the solver's own ``run_steps``, with the program's device
  counters (``k5.exact_checks``, and ``k5.interval_clears`` where the
  program has it) read before and after;
* the plain version of kernel 5 (``affine_chunked_plain``) on the card's
  tensors, and again on copies on the host, with its floor test logged
  step by step: ``lb_aff`` (the anchors' part), the Cauchy-Schwarz lift
  term ``1.25 ||wsn_y|| umax``, the per-mode interval term
  ``-sum_j min(w_j min_v U_jv, w_j max_v U_jv)`` (w the y coordinates
  rounded to the storage type, U the stored lift's y slice), the true lift
  minimum ``-min_v (w U_y)_v`` and the program's verdict;
* the kernel's own trajectory at ``--samples`` steps s: the chunk launched
  for s steps from the same anchors, the terms of the predictor of step s
  from the coefficients it returns, and the y rows' minima and maxima the
  kernel wrote (``ymm``) beside the plain version's.

It prints one JSON line: per run the steps, the trips of the bound, the
largest of each term as a share of ``lb_aff - floor``; the per-step log
goes to ``--out``.  ``--device cpu`` runs the host runs alone (a check of
the script at test sizes, ``--root`` a test checkout).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import on_host  # noqa: E402
from portbench import core  # noqa: E402
from portbench.reference import bases as bases_maker  # noqa: E402
from portbench.reference.scene import build_scene  # noqa: E402
from portbench.traffic import Requests, Traffic  # noqa: E402
from portbench.traffic import load as load_traffic  # noqa: E402

SLACK = 1.25   # the Cauchy-Schwarz bound's lift term with its slack


def terms(ao, asn, wsn, ymm, floor_h):
    """The floor test's terms of one predictor (asn, wsn) (3, 3), (3, r),
    as floats: lb_aff, the C-S, interval and true lift terms."""
    import torch

    from animsnapbases_tpu_torch.ops.resident import storage_round

    Uy = ao.res.U_liftT[1]
    u = Uy.to(wsn.dtype)
    a = asn[1]
    lb = float(torch.where(a >= 0, a * ymm[:3], a * ymm[3:]).sum())
    wy = storage_round(wsn[1], Uy.dtype)
    lo, hi = u.amin(dim=1), u.amax(dim=1)
    iv = -float(torch.where(wy >= 0, wy * lo, wy * hi).sum())
    true = -float((wy @ u).min())
    cs = SLACK * float(torch.linalg.vector_norm(wsn[1])) * ao.umax
    return {"lb_aff": lb, "gap": lb - floor_h, "cs": cs, "interval": iv,
            "true": true}


def plain_run(k5, ao, P, V, F, rb, n, iters, every, options):
    """The plain version with its floor test logged -> (log, k)."""
    log = []
    real = k5.floor_bound

    def spy(ao_, asn, wsn, ymm, floor_h, *a, **kw):
        verdict = real(ao_, asn, wsn, ymm, floor_h, *a, **kw)
        row = terms(ao_, asn, wsn, ymm, floor_h)
        row["trip"] = bool(verdict.any())
        log.append(row)
        return verdict

    k5.floor_bound = spy
    try:
        k = k5.affine_chunked_plain(ao, P, V, F, rb, n, iters,
                                    rebase_every=every, options=options)[2]
    finally:
        k5.floor_bound = real
    return log, k


def kernel_samples(k5, ao, P, V, F, rb, n, iters, samples):
    """The kernel's trajectory: the chunk launched for s steps, the terms of
    the predictor of step s from its coefficients -> (rows, ymm)."""
    import torch

    from animsnapbases_tpu_torch.ops.affine import AffineContext, AffineState
    from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc
    from animsnapbases_tpu_torch.ops.resident import force_term, project

    ro = ao.res
    fa = force_term(ro, F)
    fas, bu_fa = gather_vc(ao.fused, fa), project(ro, fa)
    bu0, bu1, b0s, b1s = k5.chunk_anchors(ao, P, V)
    ctx = AffineContext(ao, fa, bu_fa)
    plain_ymm = P.new_empty(6)
    k5.fill_ymm(plain_ymm, P, V, fa, True)
    rows, ymm = [], None
    for s in sorted({max(1, n * (j + 1) // samples) for j in range(samples)}):
        ymm = P.new_full((6,), float("nan"))
        ap, av, wp, wv, k = k5._chunk_cuda(ao, P, V, fa, ymm, True, b0s, b1s,
                                           fas, bu0, bu1, bu_fa, rb, s, iters,
                                           ao.floor_level)
        st = AffineState(b0=P, b1=V, ap=ap, av=av, wp=wp, wv=wv)
        _, _, _, _, _, asn, wsn = ctx.predictor(st)
        row = terms(ao, asn, wsn, plain_ymm, ao.floor_level)
        row.update(step=s, k=k)
        rows.append(row)
    torch.cuda.synchronize()
    return rows, {"kernel": ymm.tolist(), "plain": plain_ymm.tolist()}


def summary(log):
    """Trips and the largest of each term over ``lb_aff - floor``."""
    out = {"steps": len(log)}
    if "trip" in log[0]:
        out["trips"] = sum(r["trip"] for r in log)
    for key in ("cs", "interval", "true"):
        out[f"{key}_max_share"] = max(r[key] / r["gap"] for r in log)
    out["gap_min"] = min(r["gap"] for r in log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--request", type=int, default=0)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT),
                    help="a checkout's root (default: this one)")
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    import torch

    import animsnapbases_tpu_torch.ops.affine_chunked as k5
    from animsnapbases_tpu_torch.utils.profiling import counters

    root = Path(a.root)
    spec = core.load_spec(root)
    wl = core.find(spec["workloads"], a.workload, "workload")
    cfg = core.load_config(root, spec, wl["config"])
    traffic = Traffic(load_traffic(root, wl["traffic"]), a.seed)
    made = bases_maker.make(cfg, log=core.log)
    scene = build_scene(cfg)
    P0, V0, F0 = Requests(traffic, scene.positions, scene.mass,
                          made["tail_velocity"])(a.request)
    model = core.program_model(scene, cfg)
    args = core.program_args(cfg, made)
    solver = core.program_solver(cfg, args, a.device)
    solver.set_model(model)
    solver.prepare(args)
    iters, n = int(cfg["iterations"]), traffic.steps

    seen = {}
    fast = solver._resident_fast

    def spy_fast(*call):
        seen["call"] = call
        return fast(*call)

    solver._resident_fast = spy_fast
    before = counters()
    model.positions, model.velocities = P0.copy(), V0.copy()
    solver.frame = 0
    solver.run_steps(F0.copy(), n, num_iterations=iters)
    after = counters()
    P, V, F, rb, n_call, it = seen["call"]
    ao, every, options = solver._affine, solver._chunk_every, \
        solver._chunk_opts
    moved = {name: after[name] - before.get(name, 0) for name in after
             if name.startswith("k5.") or name == "steps.tier1"}
    result = {"workload": a.workload, "seed": a.seed, "request": a.request,
              "umax": ao.umax, "floor_h": ao.floor_level,
              "kernel_counters": moved, "runs": {}}
    logs = {}
    if P.is_cuda:
        result["device"] = torch.cuda.get_device_name(0)
        logs["card_plain"], k = plain_run(k5, ao, P, V, F, rb, n_call, it,
                                          every, options)
        result["runs"]["card_plain"] = dict(summary(logs["card_plain"]),
                                            k=k)
        rows, ymm = kernel_samples(k5, ao, P, V, F, rb, n_call, it,
                                   a.samples)
        logs["kernel_samples"] = rows
        result["runs"]["kernel_samples"] = summary(rows)
        result["ymm"] = ymm
        result["kernel_vs_plain_at_samples"] = [
            {"step": r["step"], "cs": r["cs"],
             "plain_cs": logs["card_plain"][r["step"]]["cs"]
             if r["step"] < len(logs["card_plain"]) else None,
             "interval": r["interval"], "true": r["true"]}
            for r in rows]
    host = on_host(ao)
    logs["host_plain"], k = plain_run(k5, host, P.cpu(), V.cpu(), F.cpu(),
                                      rb.cpu(), n_call, it, every, options)
    result["runs"]["host_plain"] = dict(summary(logs["host_plain"]), k=k)
    text = json.dumps(result)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(dict(result, logs=logs)) + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
