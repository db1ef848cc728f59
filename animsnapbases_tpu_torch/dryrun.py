"""``dryrun_multichip(n)``: the sharded paths on n ranks, each against its
single-process result.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` and its
``_dryrun_*`` helpers.  It spawns ``n`` ranks (``parallel/launch.py``), or
runs in the caller's process group when one of at least ``n`` ranks
exists, and runs four paths:

* the data-parallel x element-sharded full-order step on a (2, n/2)
  ("data", "model") mesh (a (1, n) one for odd n or n < 4) on the
  flagship 6x6 cloth: each data rank steps its sim with the elements
  split over "model", against ``make_ensemble_step``'s single-sim core;
* the sharded serving on both routes (``make_batched_run(mesh=...)`` over
  "data", 2 sims a data rank, the synthetic-basis 8x8 flagship): batched
  kernel 3 (the resident route) and kernel 5 with its windows on kernel 2
  (the large-model route, ``CHUNKED_TIER1_MIN_VERTS = 0``), each sim
  against the single-process batch (whether bit for bit is printed: on
  the card each sim is one cluster, on the CPU the plain versions' batched
  products round by batch size);
* the tensor-parallel reduced step (``make_tp_reduced_step`` over
  "model") on a 101x101 cloth with synthetic bases (K = 12, r = 14)
  against the single-process fully reduced step (``step()``);
* the sharded snapshot POD of a 120,001 x 16 matrix over "model" against
  ``snapshot_pod`` (signs aligned).

The full-order paths are float64 everywhere and held at 1e-9 of each
result's extent, the POD at 1e-10 and its singular values at 1e-12
relative; the reduced paths at 1e-9 on the CPU (float64) and 1e-4 on the
card (float32 state); rank 0 prints one line of the differences.  ``python -m animsnapbases_tpu_torch.dryrun
N [--cpu]`` runs it from a shell.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the flagship cloth of ``__graft_entry__._flagship`` (the smoke battery's)
from animsnapbases_tpu_torch.smoke import cloth, gravity

# relative holds (of each result's largest entry): the float64 paths, the
# float32 state of the reduced paths on the card, the POD
TOL = 1e-9
TOL32 = 1e-4
POD_TOL = 1e-10


def _hold(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip failed: {what}")


def synthetic(rows, cols, dev, K=4, r=6, **switches):
    """The flagship cloth's fully reduced solver on synthetic bases
    (``utils/synthetic.py``), ``switches`` set on the solver before a
    second prepare -> (solver, model)."""
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = cloth(rows, cols)
    solver = synthetic_reduced_solver(model, K=K, r=r, device=dev)
    if switches:
        for k, v in switches.items():
            setattr(solver, k, v)
        solver.prepare(solver.args)
    return solver, model


def rel(a, b) -> float:
    """max |a - b| over the largest entry of b."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def mesh_shape(n: int):
    return (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)


def dp_tp_step(mesh, dev, rows=6, iters=2):
    """The data-parallel x element-sharded step: this rank's sim (sim b
    under force (1 + 0.1 b) g) -> (its q, the single-sim q)."""
    from animsnapbases_tpu_torch.parallel import make_element_sharded_step
    from animsnapbases_tpu_torch.parallel.collectives import axis_of
    from animsnapbases_tpu_torch.parallel.ensemble import (
        _single_sim_step_core,
    )

    model = cloth(rows, rows)
    step = make_element_sharded_step(model, 0.016, mesh, elem_axis="model",
                                     num_iterations=iters, device=dev)
    _, _, b = axis_of(mesh, "data")
    f = torch.as_tensor(gravity(model, 1.0 + 0.1 * b), device=dev)
    pos = torch.as_tensor(model.positions, device=dev)
    q, _ = step(pos, torch.zeros_like(pos), f)
    core = _single_sim_step_core(model, 0.016, dev)
    q1, _ = core(pos, torch.zeros_like(pos), f, num_iterations=iters)
    return q.cpu().numpy(), q1.cpu().numpy()


def sharded_serving(mesh, dev, steps=5, iters=4):
    """Both sharded routes over "data", 2 sims a data rank -> [(route's
    path, max relative difference from the single-process batch, bit for
    bit)]."""
    from animsnapbases_tpu_torch.parallel.collectives import axis_of

    _, n_dp, _ = axis_of(mesh, "data")
    B = 2 * n_dp
    out = []
    for switches in ({}, {"CHUNKED_TIER1_MIN_VERTS": 0}):
        solver, model = synthetic(8, 8, dev, **switches)
        fs = np.stack([gravity(model, 1.0 + 0.1 * b) for b in range(B)])
        pos = np.repeat(model.positions[None], B, axis=0)
        vel = np.zeros_like(pos)
        p, _ = solver.make_batched_run(mesh, batch_axis="data")(
            pos, vel, fs, steps, num_iterations=iters)
        path = solver._last_batched_path
        p1, _ = solver.make_batched_run()(pos, vel, fs, steps,
                                          num_iterations=iters)
        out.append((path, rel(p, p1), bool(np.array_equal(p, p1))))
    return out


def tp_reduced_step(mesh, dev, rows=101, K=12, r=14, iters=4):
    """The TP-reduced step and the single-process fully reduced step from
    the rest state under gravity -> (q, q1, vertices)."""
    from animsnapbases_tpu_torch.parallel import make_tp_reduced_step

    solver, model = synthetic(rows, rows, dev, K=K, r=r)
    f = gravity(model)
    pos = model.positions.copy()
    q, _ = make_tp_reduced_step(solver, mesh, elem_axis="model")(
        pos, np.zeros_like(pos), f, num_iterations=iters)
    solver.step(f, num_iterations=iters)
    return q.cpu().numpy(), model.positions, model.n_verts


def sharded_pod(mesh, dev, n_rows=120_001, cols=16):
    """The sharded and single snapshot POD of a seeded (n_rows, cols)
    matrix -> (U diff, relative s diff) after aligning signs."""
    from animsnapbases_tpu_torch.ops.podlinalg import (
        snapshot_pod,
        snapshot_pod_sharded,
    )

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n_rows, cols)) * np.geomspace(10.0, 0.1, cols)
    U1, s1, _ = snapshot_pod(X, device=dev)
    U, s, _ = snapshot_pod_sharded(X, mesh, axis="model", device=dev)
    U1, U = U1.cpu().numpy(), U.cpu().numpy()
    signs = np.sign(np.sum(U1 * U, axis=0))
    return (float(np.abs(U * signs - U1).max()),
            float(np.abs(s.cpu().numpy() - s1.cpu().numpy()).max()
                  / float(s1[0])))


def _dryrun(n: int, device) -> dict:
    """The four paths on this rank of an n-rank group -> their readings;
    raises ``RuntimeError`` on a failed hold."""
    import torch.distributed as dist

    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.parallel import build_device_mesh

    dev = resolve_device(device)
    shape = mesh_shape(n)
    mesh = build_device_mesh(shape, ("data", "model"), dev)
    # float32 state on the card (its kernels' dtype), float64 on the CPU
    tol = TOL if dev.type == "cpu" else TOL32
    q, q1 = dp_tp_step(mesh, dev)
    out = {"mesh": shape, "dp_tp": rel(q, q1)}
    out["serving"] = sharded_serving(mesh, dev)
    q, q1, nv = tp_reduced_step(mesh, dev)
    out["tp"], out["tp_verts"] = rel(q, q1), nv
    out["pod"], out["pod_s"] = sharded_pod(mesh, dev)
    (rp, rd, _), (cp, cd, _) = out["serving"]
    _hold(out["dp_tp"] <= TOL, f"DP x element-sharded step {out}")
    _hold(rp == f"batched-resident-sharded[{shape[0]}x2]"
          and cp.startswith(f"batched-chunked-sharded[{shape[0]}x2]"),
          f"sharded serving routes {out}")
    _hold(max(rd, cd, out["tp"]) <= tol, f"sharded serving, TP {out}")
    _hold(out["pod"] <= POD_TOL and out["pod_s"] <= 1e-12,
          f"sharded POD {out}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh {shape} axes ('data', 'model') on "
              f"{dev.type}; DP x element-sharded step max rel diff "
              f"{out['dp_tp']:.2e}; sharded serving "
              + ", ".join(f"{p} ({d:.2e}{', bit for bit' if b else ''})"
                          for p, d, b in out["serving"])
              + f"; TP-reduced {nv}-vertex step {out['tp']:.2e}; sharded "
              f"POD 120001x16 U {out['pod']:.2e}, s {out['pod_s']:.2e}",
              flush=True)
    return out


def _dryrun_rank(rank, world, n, device):
    _dryrun(n, device)


def dryrun_multichip(n: int, device=None, backend: str = "gloo",
                     timeout: float = 600.0) -> None:
    """Run the four sharded paths on ``n`` ranks (see the module
    docstring): in the caller's process group when it has at least ``n``
    ranks (every rank calls this), else on ``n`` spawned ranks of a
    ``backend`` group.  ``device`` defaults to the card."""
    import torch.distributed as dist

    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.parallel.launch import run_ranks

    dev = resolve_device(device)
    if dist.is_initialized() and dist.get_world_size() >= n:
        _dryrun(n, dev)
        return
    run_ranks(n, _dryrun_rank, (n, str(dev)), backend=backend,
              timeout=timeout, threads=1 if dev.type == "cpu" else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
