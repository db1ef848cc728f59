"""The bench scene's record -> bases -> reduced solve, the JAX package's
pipeline against the port's, both on the CPU in float64.

    python3 tools/pipeline_parity.py [--rows 120] [--frames 48]
        [--constr-modes 40] [--pos-modes 64]

The JAX side is ``bench.py``'s own (``_run_fom_and_bases_impl``: the host-LU
recording, ``pod_vectorized`` with row DEIM, the POD position basis; then
``build_reduced_solver`` at float64, whose fused kernels stay off on the
CPU, and ``run_steps(48)`` from the hang state); the port's is
``animsnapbases_tpu_torch.bases.pipeline`` on ``device="cpu"`` with the
port's ``AnimSnapBasesSolver`` (its plain versions).  Printed, one JSON
object: the FOM trajectories' distance (relative to the scene's extent),
the p-snapshots' distance, per group the DEIM picks' agreement, the
components' distance up to each mode's sign and the singular values'
relative distance (by mode), the position bases' distance, the two reduced
trajectories' distance after 48 steps, both reduced-vs-FOM statistics
(``bench.py``'s mean, p99 and max of |P - P_FOM| / max|P_FOM|), and the
JAX reduced solver's run on the port's bases files.  This tool imports
both packages; the port and ``chip_smoke.py`` import no JAX.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    with tempfile.TemporaryDirectory(prefix="pipeline_parity_") as tmp:
        print(json.dumps(run(tmp)))


def run(tmp):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=120)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--constr-modes", type=int, default=40)
    ap.add_argument("--pos-modes", type=int, default=64)
    opts = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import bench
    import chip_smoke as cs
    from animsnapbases_tpu.geometry.procedural import cloth_model as jcloth
    from animsnapbases_tpu.ops.podlinalg import snapshot_pod
    from animsnapbases_tpu_torch.bases.pipeline import (
        build_bases,
        fom_deviation,
        record_fom,
        reduced_args,
    )
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver

    rows, frames = opts.rows, opts.frames
    bench.BENCH_DIR = os.path.join(tmp, "jax")
    bench.FOM_FRAMES = frames
    bench.CONSTR_MODES = opts.constr_modes
    bench.POS_MODES = opts.pos_modes

    def mesh():
        V, F = jcloth(rows, rows)
        V = V / float(rows)
        V[:, 2] += 0.05 * V[:, 0]
        V = V - V.mean(axis=0)
        return (V / np.abs(V).max()).astype(np.float64), \
            F.astype(np.int64), f"cloth {rows}x{rows}"

    bench.load_mesh = mesh
    out = {"rows": rows, "vertices": rows * rows, "frames": frames,
           "constr_modes": opts.constr_modes, "pos_modes": opts.pos_modes}
    t0 = time.perf_counter()
    meta = bench.run_fom_and_bases()
    out["jax_fom_and_bases_s"] = time.perf_counter() - t0
    traj_j = np.load(os.path.join(bench.BENCH_DIR, "traj.npy"))

    model = cs.bench_scene(DeformableModel, lambda r, c: cloth_model(rows,
                                                                     rows))
    f = cs.gravity(model)
    work = os.path.join(tmp, "port")
    record = os.path.join(work, "FOM")
    t0 = time.perf_counter()
    traj, fom = record_fom(model, f, record, frames, bench.FOM_ITERS,
                           bench.DT, bench.DAMPING, device="cpu")
    out["port_fom_s"] = time.perf_counter() - t0
    out["port_fom_seconds_split"] = fom.seconds
    extent = float(np.abs(traj_j).max())
    out["fom_traj_rel"] = float(np.abs(traj - traj_j).max()) / extent
    timings = {}
    basis_dir, pos_path, groups = build_bases(
        model, record, traj, work, bench.CONSTR_MODES, bench.POS_MODES,
        device="cpu", timings=timings)
    out["port_bases_s"] = timings
    for gname, cc in groups.items():
        pj = np.load(os.path.join(meta["record"], gname + "_p.npz"))
        pt = np.load(os.path.join(record, gname + "_p.npz"))
        bj = np.load(os.path.join(meta["basis_dir"], gname, "basis.npz"))
        R = np.stack([pj[str(i)] for i in range(frames - 1)])
        Sj = np.asarray(snapshot_pod(jnp.asarray(
            R.reshape(frames - 1, -1).T))[1])
        comp = cs.sign_aligned_diff(bj["components"], cc.comps)
        out[gname] = {
            "p_keys_equal": sorted(pj.files) == sorted(pt.files),
            "p_max_abs": max(float(np.abs(pj[k] - pt[k]).max())
                             for k in pj.files),
            "modes": [int(len(bj["components"])), int(cc.numComp)],
            "picks_equal": bool(np.array_equal(bj["Pt"], cc.geom_Pt)),
            "picks_first_difference": (
                None if np.array_equal(bj["Pt"], cc.geom_Pt) else int(
                    np.argmax(bj["Pt"] != cc.geom_Pt))),
            "components_max_abs_by_mode": comp.tolist(),
            "singular_values": cc.singVals.tolist(),
            "singular_values_rel_diff": (np.abs(cc.singVals - Sj)
                                         / Sj).tolist(),
        }
    pj = np.load(meta["pos_path"])["components"]
    pt = np.load(pos_path)["components"]
    out["position_basis_max_abs_by_mode"] = [
        cs.sign_aligned_diff(pj[:, :, d], pt[:, :, d]).tolist() for d in range(3)]

    # the reduced solves from the hang state, 48 steps under gravity
    tail = traj_j[-1]
    solver_j, model_j = bench.build_reduced_solver(meta, None)
    if solver_j._resident is not None:
        raise RuntimeError("the JAX reduced solver built a fused kernel")
    solver_j.run_steps(bench.gravity(model_j), frames,
                       num_iterations=bench.FOM_ITERS)
    out["jax_reduced_vs_fom"] = fom_deviation(model_j.positions, tail)

    args = reduced_args(basis_dir, pos_path, min(30, bench.CONSTR_MODES),
                        bench.POS_MODES, bench.DT, bench.DAMPING)
    model_p = cs.bench_scene(DeformableModel, lambda r, c: cloth_model(rows,
                                                                       rows))
    solver_p = AnimSnapBasesSolver(args, device="cpu", dtype=torch.float64)
    solver_p.set_model(model_p)
    solver_p.prepare(args)
    solver_p.run_steps(f, frames, num_iterations=bench.FOM_ITERS)
    out["port_reduced_vs_fom"] = fom_deviation(model_p.positions, traj[-1])
    out["reduced_traj_rel"] = float(
        np.abs(model_p.positions - model_j.positions).max()) / extent

    # the JAX reduced solver on the port's bases files
    solver_x, model_x = bench.build_reduced_solver(
        dict(meta, basis_dir=basis_dir, pos_path=pos_path), None)
    solver_x.run_steps(bench.gravity(model_x), frames,
                       num_iterations=bench.FOM_ITERS)
    out["jax_on_port_bases_vs_port_rel"] = float(
        np.abs(model_x.positions - model_p.positions).max()) / extent
    return out


if __name__ == "__main__":
    main()
