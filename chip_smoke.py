"""Smoke of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.

Drives the port's serving path on the card at the bench scene's full
width and holds each hand-written kernel against its plain PyTorch
version.  Phases, each of which fails the run when it fails:

1. device and build: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel from
   ``animsnapbases_tpu_torch/csrc``;
2. the bench scene (the 120x120 procedural cloth of ``bench.py``, 14,400
   vertices, r = 64, 40 DEIM rows per group, random bases made from fixed
   seeds, bfloat16 matrices and float32 state) through
   ``prepare -> step -> run_steps(64)``, with the launch counters of both
   kernels read around that run, and a small scene held
   against the float64 plain version on the CPU;
3. each kernel against its plain version on the card, from the same state;
4. times (CUDA events, median of the repetitions after warm-up) beside each
   kernel's bound from its bytes and operations;
5. the ``kernels`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense; float32 and float64
# on the CUDA cores, where these kernels compute): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.  Bytes are priced at the HBM rate even where
# they come from L2: NVIDIA publishes no L2 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}
# floating-point operations of one projection row, counted from
# csrc/iteration.cuh (the 2x2 clamp with its two half-angle steps, and the
# spring row)
TRI_FLOPS = 110
SPRING_FLOPS = 20

SCENE_STEPS = 64
ITERATIONS = 10
WINDOW_STEPS = 2000
REPS = 50
# kernel 1 vs its plain version on the card: both run in float32 from the
# same inputs and are held against the float64 plain result from those
# inputs.  Their float32 errors are of one size (the same arithmetic in
# another order); the kernel fails when its error exceeds ACC_RATIO times
# the plain version's.
ACC_RATIO = 4.0
F32_EPS = 2.0 ** -23
# kernel 2 vs its plain version, step by step from the same state: both
# round sn to the storage type bit for bit, so they differ only by the
# order of their float32 sums, which the nonlinear loop amplifies at some
# states (up to ~3% of the step's lift at the bench scene).  Each step's
# difference must stay below STEP_TOL times that step's own size: its
# change of P and the lift U u within it for P, its change of V for V.  A
# kernel that skipped or misweighted a part of the step fails.  (A float64
# reference cannot hold it tighter: at a few states the loop's clamps
# branch differently in float64, and it then parts from both float32
# versions by ~0.1 in P within one step.)
STEP_TOL = 0.1
# the small scene on the card (float32) against the plain float64
# version on the CPU
TOL_SMALL = 1e-3


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def bench_scene(DeformableModel, cloth_model):
    """The bench scene without the reference mesh (bench.py:73-109): the
    120x120 procedural cloth, normalized, hung 20 units up, masses 10, the
    top cap above the 0.80 quantile pinned, tris_strain (0.95-1.05) and
    edge_spring at wi = 1e4, floor on."""
    V, F = cloth_model(120, 120)
    V = V / 120.0
    V[:, 2] += 0.05 * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    V[:, 1] += 20.0
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    top = np.where(model.positions[:, 1]
                   > np.quantile(model.positions[:, 1], 0.80))[0]
    for vi in top:
        model.fix(vi)
    return model


def small_scene(DeformableModel, cloth_model):
    V, F = cloth_model(10, 10)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=0.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    for vi in np.where(model.positions[:, 0] < 0.5)[0]:
        model.fix(vi)
    return model


def free_position_basis(model, r, path, seed=1):
    """A random per-dim orthonormal position basis (r modes) that is zero at
    the pinned vertices, written as ``components`` (r, N, 3).  A recorded
    POD basis is ~0 there; a basis that moves pinned vertices puts their
    1e10 masses into U^T A U, and the reduced solve then does next to
    nothing (|u| ~ 1e-8 at the bench scene), which would leave the
    iteration loop unexercised."""
    rng = np.random.default_rng(seed)
    comps = np.empty((r, model.n_verts, 3))
    for d in range(3):
        X = rng.normal(size=(model.n_verts, r))
        X[model.fixed_flags] = 0.0
        Q, _ = np.linalg.qr(X)
        comps[:, :, d] = Q.T
    np.savez(path, components=comps)
    return path


def scene_solver(synthetic_reduced_solver, model, K, r, damping, **kw):
    """The synthetic constraint bases of ``utils/synthetic.py`` with the
    position basis of :func:`free_position_basis`."""
    with tempfile.TemporaryDirectory() as tmp:
        pos = free_position_basis(model, r, os.path.join(tmp, "free.npz"))
        return synthetic_reduced_solver(
            model, K=K, r=r, work_dir=tmp,
            extra_args={"damping": damping, "position_basis_file": pos}, **kw)


def gravity(model):
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0
    return f


def cuda_ms(torch, fn, reps=REPS, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` calls, each between two
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def as_accurate(got, plain, ref64):
    """(ok, kernel error, plain error) against the float64 result from the
    same inputs.  Kernel and plain version do the same float32 arithmetic
    in another order, so their errors are of one size: the kernel passes
    when its error is within ACC_RATIO times the plain version's or the
    float32 rounding of the result's largest entry, whichever is larger."""
    e_k = max_abs(got, ref64)
    e_p = max_abs(plain, ref64)
    floor = F32_EPS * float(ref64.abs().max())
    return e_k <= ACC_RATIO * max(e_p, floor), e_k, e_p


def as_f64(fo):
    """The fused operands with their float values widened to float64."""
    return dataclasses.replace(
        fo, C_allT=fo.C_allT.double(), inv3=fo.inv3.double(),
        WT_all=fo.WT_all.double(), elem_f=fo.elem_f.double())


def k1_cost(fo, n_sel, iters):
    """(bytes, {dtype: ops}) of one kernel-1 call: every input read once,
    the output written once."""
    it = fo.C_allT.element_size()
    r, g, m = fo.r, fo.g_total, fo.m_total
    nbytes = (it * (3 * n_sel + 3 * r + fo.C_allT.numel() + fo.inv3.numel()
                    + fo.WT_all.numel() + fo.elem_f.numel() + 3 * r)
              + 4 * (fo.gidx.numel() + fo.elem_kind.numel()
                     + fo.elem_g.numel()))
    elem = sum(m_ * (TRI_FLOPS if k == "tris_strain" else SPRING_FLOPS)
               for k, _, m_, _, _ in fo.segments)
    ops = iters * (2 * 3 * r * g + 2 * 3 * m * r + elem) + 2 * 3 * r * r
    return nbytes, {"float32": ops}


def k2_cost(ro, steps, iters):
    """(bytes, {dtype: ops}) of one kernel-2 call of ``steps`` steps.  Each
    step reads the two (3, r, N) matrices, the state P, V and the force
    term, writes P and V, and reads the loop's operands; the projection
    U^T A_c sn accumulates in float64 and the lift in float32
    (csrc/resident.cu)."""
    fo = ro.fused
    n, r = ro.n, fo.r
    it = fo.C_allT.element_size()
    k1_bytes, k1_ops = k1_cost(fo, 0, iters)
    step_bytes = (ro.U_liftT.element_size() * (ro.U_liftT.numel()
                                               + ro.ut_acT.numel())
                  + it * 3 * n * 5 + k1_bytes)
    ops = {"float64": steps * 2 * 3 * r * n,
           "float32": steps * (2 * 3 * r * n + k1_ops["float32"] + 3 * n * 8)}
    return steps * step_bytes, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(v / PEAK_OPS[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.ops import _build
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        resident_multistep,
        resident_multistep_plain,
    )
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    dev = resolve_device("cuda")
    torch.manual_seed(0)

    # ---- 1. device and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} nvcc: {nvcc}")
    t0 = time.perf_counter()
    info = _build.build()
    log(f"[1] built {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for name, rec in sorted(info.items()):
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # ---- 2. the bench scene through the entry points -------------------
    t0 = time.perf_counter()
    model = bench_scene(DeformableModel, cloth_model)
    solver = scene_solver(synthetic_reduced_solver, model, K=40, r=64,
                          damping=2e-3, device=dev, dtype=torch.float32,
                          matmul_dtype=torch.bfloat16)
    ro = solver._resident
    fo = ro.fused
    log(f"[2] prepare {time.perf_counter() - t0:.1f} s: N={ro.n} r={fo.r} "
        f"n_sel={ro.n_sel} g_total={fo.g_total} m_total={fo.m_total} "
        f"storage={ro.ut_acT.dtype}")
    f = gravity(model)
    fused_reduced_iterations.launches = 0
    resident_multistep.launches = 0
    t0 = time.perf_counter()
    solver.step(f, num_iterations=ITERATIONS)
    solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS)
    torch.cuda.synchronize()
    launches = {"fused_reduced_iterations": fused_reduced_iterations.launches,
                "resident_multistep": resident_multistep.launches}
    log(f"[2] step + run_steps({SCENE_STEPS}) "
        f"{time.perf_counter() - t0:.2f} s, launches {launches}")
    require(model.positions.shape == (ro.n, 3), "state shape")
    require(np.isfinite(model.positions).all(), "non-finite positions")
    require(np.isfinite(model.velocities).all(), "non-finite velocities")
    for name, count in launches.items():
        require(count > 0, f"{name} was never launched on the main path")
    log(f"[2] state finite; y in [{model.positions[:, 1].min():.4f}, "
        f"{model.positions[:, 1].max():.4f}], "
        f"|v|max {np.abs(model.velocities).max():.4f}")

    # the small scene on the card against the float64 plain version
    results = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = small_scene(DeformableModel, cloth_model)
        s = scene_solver(synthetic_reduced_solver, m, K=6, r=8,
                         damping=0.07, device=device, dtype=dtype)
        g = gravity(m)
        s.step(g, num_iterations=6)
        s.run_steps(g, 7, num_iterations=6)
        results.append(m.positions.copy())
    d = float(np.abs(results[0] - results[1]).max())
    scale = float(np.abs(results[1]).max())
    log(f"[2] small scene, card f32 vs CPU f64 plain after 8 steps: "
        f"max|dP| {d:.3e} (rel {d / scale:.3e}, tol {TOL_SMALL})")
    require(d <= TOL_SMALL * scale, "small scene disagrees with the reference")

    # ---- 3. kernels against their plain versions -----------------------
    P = solver._to_device(model.positions)
    V = solver._to_device(model.velocities)
    Fx = solver._to_device(f)
    rb_extra = solver._rb_extra()
    sn, rb_const = predict(ro, P, V, force_term(ro, Fx), rb_extra)
    snT_sel = sn[:, :ro.n_sel]
    u_k = fused_reduced_iterations(fo, snT_sel, rb_const, ITERATIONS)
    u_p = fused_reduced_iterations_plain(fo, snT_sel, rb_const, ITERATIONS)
    fo64 = as_f64(fo)
    u_64 = fused_reduced_iterations_plain(fo64, snT_sel.double(),
                                          rb_const.double(), ITERATIONS)
    torch.cuda.synchronize()
    k1_abs = max_abs(u_k, u_p)
    ok, e_k, e_p = as_accurate(u_k, u_p, u_64)
    log(f"[3] kernel 1, u after {ITERATIONS} iterations: vs plain max abs "
        f"{k1_abs:.3e} (max|u| {float(u_p.abs().max()):.3e}); vs float64: "
        f"kernel {e_k:.3e}, plain {e_p:.3e} (limit {ACC_RATIO}x)")
    require(bool(torch.isfinite(u_k).all()) and ok,
            "kernel 1 is less accurate than its plain version")

    # kernel 2: a 64-step call must equal 64 one-step calls bit for bit
    # (the in-kernel step loop), and each of those steps is held against
    # the plain version from the same state (STEP_TOL).  A 64-step free run
    # is not held to a tolerance: with these random bases the step map
    # amplifies float32 rounding ~1.2x per step, so any two float32 orders
    # part by ~0.1-0.3 in position after 64 steps (printed below).
    k2_err = {}
    ro_f32 = dataclasses.replace(ro, U_liftT=ro.U_liftT.float(),
                                 ut_acT=ro.ut_acT.float())
    fa = force_term(ro, Fx)
    for label, r_ops in (("bfloat16", ro), ("float32", ro_f32)):
        # float64 plain version with the matrices in their storage type, so
        # that it rounds sn and u to it where the float32 versions do;
        # printed, not held (see STEP_TOL)
        ro64 = dataclasses.replace(r_ops, fused=fo64,
                                   mass_inv=r_ops.mass_inv.double())
        P_all, V_all = resident_multistep(r_ops, P, V, Fx, rb_extra,
                                          SCENE_STEPS, ITERATIONS)
        Pi, Vi = P, V
        # per key: largest difference, largest share of the step's size,
        # smallest step size over the steps
        diff = {"P": 0.0, "V": 0.0}
        share = {"P": 0.0, "V": 0.0}
        size = {"P": float("inf"), "V": float("inf")}
        off64 = [0.0, 0.0]
        for _ in range(SCENE_STEPS):
            Pk, Vk = resident_multistep(r_ops, Pi, Vi, Fx, rb_extra, 1,
                                        ITERATIONS)
            Pp, Vp = resident_multistep_plain(r_ops, Pi, Vi, Fx, rb_extra,
                                              1, ITERATIONS)
            P64, _ = resident_multistep_plain(
                ro64, Pi.double(), Vi.double(), Fx.double(),
                rb_extra.double(), 1, ITERATIONS)
            off64 = [max(off64[0], max_abs(Pk, P64)),
                     max(off64[1], max_abs(Pp, P64))]
            sn, _ = predict(r_ops, Pi, Vi, fa, rb_extra)
            require(bool(torch.isfinite(Pk).all()
                         and torch.isfinite(Vk).all()),
                    f"kernel 2 ({label} storage): non-finite state")
            step_size = {"P": min(max_abs(Pp, Pi), max_abs(Pp, sn)),
                         "V": max_abs(Vp, Vi)}
            for key, got, plain in (("P", Pk, Pp), ("V", Vk, Vp)):
                d, s = max_abs(got, plain), step_size[key]
                require(d <= STEP_TOL * s,
                        f"kernel 2 ({label} storage) {key}: differs from "
                        f"the plain version by {d:.3e}, above {STEP_TOL} "
                        f"of the step's size {s:.3e}")
                diff[key] = max(diff[key], d)
                share[key] = max(share[key], d / s if s > 0 else 0.0)
                size[key] = min(size[key], s)
            Pi, Vi = Pk, Vk
        torch.cuda.synchronize()
        same = bool(torch.equal(P_all, Pi) and torch.equal(V_all, Vi))
        log(f"[3] kernel 2 ({label} storage), {SCENE_STEPS} steps: one "
            f"{SCENE_STEPS}-step call == {SCENE_STEPS} one-step calls: "
            f"{same}; per step vs plain: " + "; ".join(
                f"{key} max abs {diff[key]:.3e}, at most {share[key]:.3e} "
                f"of the step's size (tol {STEP_TOL}), smallest step size "
                f"{size[key]:.3e}" for key in ("P", "V"))
            + f"; largest P distance from the float64 step (not held): "
            f"kernel {off64[0]:.3e}, plain {off64[1]:.3e}")
        require(same, f"kernel 2 ({label} storage): the step loop differs "
                "from repeated single steps")
        k2_err[label] = max(diff.values())
        Pp, Vp = resident_multistep_plain(r_ops, P, V, Fx, rb_extra,
                                          SCENE_STEPS, ITERATIONS)
        log(f"[3]   free {SCENE_STEPS}-step run, kernel vs plain (not held "
            f"to a tolerance): P {max_abs(P_all, Pp):.3e}, "
            f"V {max_abs(V_all, Vp):.3e}")

    # ---- 4. times --------------------------------------------------------
    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations(
        fo, snT_sel, rb_const, ITERATIONS), reps=200)
    k1_plain_ms = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, snT_sel, rb_const, ITERATIONS))
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS))
    log(f"[4] kernel 1: {1e3 * k1_ms:.2f} us/call at {ITERATIONS} "
        f"iterations; plain {1e3 * k1_plain_ms:.1f} us; bound "
        f"{1e3 * k1_bound:.4f} us ({k1_by})")
    # where kernel 1's time goes: the slope over the iteration count is
    # the loop body, the intercept the launch, the gather and the solve
    k1_at = {it: cuda_ms(torch, lambda it=it: fused_reduced_iterations(
        fo, snT_sel, rb_const, it), reps=100) for it in (0, 1, 20)}
    log(f"[4] kernel 1 by iterations: " + ", ".join(
        f"{it}: {1e3 * ms:.2f} us" for it, ms in k1_at.items())
        + f"; slope {1e3 * (k1_at[20] - k1_at[1]) / 19:.3f} us/iteration")

    def k2_call():
        return resident_multistep(ro, P, V, Fx, rb_extra, SCENE_STEPS,
                                  ITERATIONS)

    k2_ms = cuda_ms(torch, k2_call)
    k2_plain_ms = cuda_ms(torch, lambda: resident_multistep_plain(
        ro, P, V, Fx, rb_extra, SCENE_STEPS, ITERATIONS), reps=REPS,
        warmup=1)
    k2_bound, k2_by = bound_ms(*k2_cost(ro, SCENE_STEPS, ITERATIONS))
    window_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, P, V, Fx, rb_extra, WINDOW_STEPS, ITERATIONS), warmup=1)
    # kernel 2 with no iterations: predictor, projection, solve and lift
    # launches alone
    k2_noiter_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, P, V, Fx, rb_extra, SCENE_STEPS, 0))
    # the entry point over the same window, host transfers included
    t0 = time.perf_counter()
    solver.run_steps(f, WINDOW_STEPS, num_iterations=ITERATIONS)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    require(np.isfinite(model.positions).all(), "non-finite window state")
    # the one part a single library call computes: the (3, r, N) x (3, N)
    # projection and the lift, as torch.matmul on the stored matrices (the
    # port never calls it on the kernel path)
    snm = sn.to(ro.ut_acT.dtype)[:, :, None]
    um = u_k.to(ro.U_liftT.dtype)[:, None, :]
    part_ms = cuda_ms(torch, lambda: (torch.matmul(ro.ut_acT, snm),
                                      torch.matmul(um, ro.U_liftT)))
    log(f"[4] kernel 2: {1e3 * k2_ms / SCENE_STEPS:.2f} us/step "
        f"({k2_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k2_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k2_bound / SCENE_STEPS:.4f} us/step ({k2_by})")
    log(f"[4] kernel 2 at 0 iterations: "
        f"{1e3 * k2_noiter_ms / SCENE_STEPS:.2f} us/step")
    log(f"[4] kernel 2 over {WINDOW_STEPS} steps (median of {REPS}): "
        f"{1e3 * window_ms / WINDOW_STEPS:.2f} us/step = "
        f"{WINDOW_STEPS / (window_ms / 1e3):.0f} steps/s; run_steps entry "
        f"point {WINDOW_STEPS / entry_s:.0f} steps/s")
    log(f"[4] library part (torch.matmul projection + lift, one step): "
        f"{1e3 * part_ms:.2f} us")

    # ---- 5. kernel list and result -------------------------------------
    kernels = [
        {"name": "fused_reduced_iterations", "route": "cuda",
         "source": "animsnapbases_tpu_torch/csrc/fused_reduced.cu",
         "replaces": "animsnapbases_tpu/ops/pallas_reduced.py:393",
         "launches": launches["fused_reduced_iterations"],
         "max_abs_err": k1_abs, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "resident_multistep", "route": "cuda",
         "source": "animsnapbases_tpu_torch/csrc/resident.cu",
         "replaces": "animsnapbases_tpu/ops/pallas_resident.py:415",
         "launches": launches["resident_multistep"],
         "max_abs_err": k2_err["bfloat16"], "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "steps_per_call": SCENE_STEPS,
         "library_part_ms_per_step": part_ms,
         "window_steps_per_s": WINDOW_STEPS / (window_ms / 1e3)},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
