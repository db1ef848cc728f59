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
   ``prepare -> step -> run_steps(64)`` on the tiers (kernel 5 serves the
   whole window), then a contact scene (the cloth 0.05 above the floor,
   falling at 2 units/s) whose tier 1 exits early and whose contact tier
   (kernel 3) finishes the window; the same with
   ``resident_chunked_tier1 = False`` (kernel 4, then kernel 3) and with
   ``CHUNKED_TIER1_MIN_VERTS`` forcing kernel 2 as the contact tier.  Each
   of these runs is a path of its own: the launch counters of all five
   kernels are set to 0 just before it and read just after, and the
   path's own kernels must have launched and no other.  A small scene is
   held against the float64 plain version on the CPU;
3. each kernel against its plain version on the card, from the same state,
   step by step: in one-step calls, and in the steps that one call carries
   inside it (step s of a call of s steps against one plain step from the
   coefficients that the kernel's call of s - 1 steps left, for every s up
   to 64);
4. times (CUDA events, median of the repetitions after warm-up) beside each
   kernel's bound from its bytes and operations;
2-4 for ensemble serving (:func:`ensemble`): ``make_batched_run`` on a
   ring-down ensemble of 64 sims over 2,000 steps (batched kernel 3), on a
   mixed batch of 16, half of it falling onto the floor (batched kernel 3,
   then with ``CHUNKED_TIER1_MIN_VERTS = 0`` batched kernels 5 and 2), and
   ``make_batched_step`` on 64 sims (batched kernel 1), each a counted
   path; every sim of each batched kernel against the solo kernel from its
   state, bit for bit (kernels 2 and 3 on the mixed batch and on 64 sims),
   batched kernel 5's whole-batch k against the sims' solo k, one step of
   kernels 2, 3 and 5 against the plain versions on both batches; times at
   1 to 128 sims, with a torch.profiler breakdown of one batched call;
5. the ``kernels`` line (nine entries: five solo kernels, four batched
   builds), then the last line ``{"ok": true, "device": {...}}``.

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
# the peak rate of their type.  An operand that the design keeps on the
# chip between steps (shared memory or L2: the loop's operands, M_utac,
# the maps to the gathered values, the y slice of the floor test) counts
# once per call; the passes over the (3, r, N) matrices count where the
# algorithm makes them (each step of kernel 2 and each contact step of
# kernel 3, each chunk or rebase of kernels 3-5).  All bytes are priced at
# the HBM rate: NVIDIA publishes no L2 rate.
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
# the solver's defaults: kernel 5's chunk (its rebase cadence) and the
# in-kernel rebase cadence of kernels 3 and 4
CHUNK_EVERY = 1024
REBASE_EVERY = 256
# the contact scene: the bench cloth with its lowest vertex this far above
# the floor, falling at this speed (units/s)
CONTACT_GAP = 0.05
CONTACT_SPEED = 2.0
# repetitions of the plain versions' 64-step calls (~1 s each)
PLAIN_REPS = 3
# ensemble serving (make_batched_run / make_batched_step): the ring-down
# ensemble's size, the sizes its per-step time is taken at, and the
# spread of its excitations (sim b: (1 - SPREAD b) x a tenth of the main
# path's end velocity, which the 1.0 x window of phase 4 holds floor-clear
# over WINDOW_STEPS steps: at (1 + 0.02 b) the faster of 64 sims reached
# the floor); the mixed batch's size, half
# of it in the contact scene (contact sim j: CONTACT_RISE + CONTACT_STEP j
# above the contact scene's gap), and the resident_rebase_every of its
# large-model route (kernel 5's chunks, kernel 2's windows).  SIM_ROWS is
# the batched kernels' grouping of sims: a block of kernel 3's O(N)
# launches serves the sims b, b + SIM_ROWS, ... (affine.cu SIM_Y), and
# kernel 2's projection and lift and kernel 3's floor test serve groups of
# SIM_ROWS sims (resident.cu SIM_GROUP, affine.cu Y_GROUP).  The mixed
# batch spans two groups and puts its contact sims at b % SIM_ROWS >=
# SIM_ROWS / 2, so that clamping sims share blocks.
ENSEMBLE = 64
ENSEMBLE_SIZES = (1, 8, 64, 128)
SPREAD = 0.004
MIXED = 16
SIM_ROWS = 8
CONTACT_RISE = 0.15
CONTACT_STEP = 0.1
MIXED_EVERY = 16


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


def bench_solver(torch, dev):
    """(model, solver) of the bench scene at the bench's widths: r = 64,
    40 DEIM rows per group, float32 state, bfloat16 matrices."""
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    model = bench_scene(DeformableModel, cloth_model)
    return model, scene_solver(synthetic_reduced_solver, model, K=40, r=64,
                               damping=2e-3, device=dev, dtype=torch.float32,
                               matmul_dtype=torch.bfloat16)


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
        WT_all=fo.WT_all.double(), elem_f=fo.elem_f.double(),
        UG_allT=fo.UG_allT.double())


def k1_cost(fo, n_sel, iters, nb=1):
    """(bytes, {dtype: ops}) of one kernel-1 call for ``nb`` sims: every
    input read once, the output written once; the loop's operands are
    shared by the sims, the gathered state, rb_const and u are each sim's."""
    it = fo.C_allT.element_size()
    r, g, m = fo.r, fo.g_total, fo.m_total
    nbytes = (it * (nb * (3 * n_sel + 3 * r + 3 * r) + fo.C_allT.numel()
                    + fo.inv3.numel() + fo.WT_all.numel()
                    + fo.elem_f.numel())
              + 4 * (fo.gidx.numel() + fo.elem_kind.numel()
                     + fo.elem_g.numel()))
    elem = sum(m_ * (TRI_FLOPS if k == "tris_strain" else SPRING_FLOPS)
               for k, _, m_, _, _ in fo.segments)
    ops = iters * (2 * 3 * r * g + 2 * 3 * m * r + elem) + 2 * 3 * r * r
    return nbytes, {"float32": nb * ops}


def k2_cost(ro, steps, iters, nb=1):
    """(bytes, {dtype: ops}) of one kernel-2 call of ``steps`` steps for
    ``nb`` sims.  Each step reads the two (3, r, N) matrices once for all
    sims, each sim's state P, V and force term, writes P and V, and reads
    the loop's operands; the projection U^T A_c sn accumulates in float64
    and the lift in float32 (csrc/resident.cu).  A contact step of kernel 3
    costs what one sim's step costs."""
    fo = ro.fused
    n, r = ro.n, fo.r
    it = fo.C_allT.element_size()
    k1_bytes, k1_ops = k1_cost(fo, 0, iters, nb)
    step_bytes = (ro.U_liftT.element_size() * (ro.U_liftT.numel()
                                               + ro.ut_acT.numel())
                  + nb * it * 3 * n * 5 + k1_bytes)
    ops = {"float64": steps * nb * 2 * 3 * r * n,
           "float32": steps * (nb * (2 * 3 * r * n + 3 * n * 8)
                               + k1_ops["float32"])}
    return steps * step_bytes, ops




def small_cost(ao, iters, cols, nb=1):
    """(bytes per call, float32 ops per sim-step) of the contact-free affine
    steps' small operands for ``nb`` sims.  Bytes, once per call (they stay
    on the chip between steps): the loop's operands, M_utac, the map to the
    gathered values (``cols`` wide: UG_allT over g_total for kernel 5,
    U_selT over n_sel for kernels 3 and 4), shared by the sims; each sim's
    force-term projection and gathered columns.  Operations, each step of
    each sim: the loop with its solve, rb_lin and the gathered values."""
    fo = ao.fused
    r = fo.r
    loop_bytes, loop_ops = k1_cost(fo, 0, iters, nb)
    nbytes = (loop_bytes + 4 * (3 * r * r + 3 * r * cols)
              + nb * 4 * (3 * r + 3 * cols))
    ops = (loop_ops["float32"] / nb + 2 * 3 * r * r + 2 * 3 * r * cols
           + 6 * 3 * cols)
    return nbytes, ops


def big_pass(ao, nb=1):
    """(bytes, ops) of one pass over a (3, r, N) matrix, read once, with
    the (3, N) states of ``nb`` sims read or written beside it: a
    projection or a lift."""
    ro = ao.res
    return (ro.U_liftT.element_size() * ro.U_liftT.numel()
            + nb * 4 * 3 * ro.n, nb * 2 * 3 * ao.fused.r * ro.n)


def k5_cost(ao, steps, iters, every, nb=1):
    """(bytes, {dtype: ops}) of one kernel-5 call of ``steps`` contact-free
    steps for ``nb`` sims whose floor bound never trips (the exact check
    then reads nothing): per call the small operands (:func:`small_cost`),
    the force terms, their projection and their y-row extremes; per step
    the small operands' operations; per chunk the outer loop's two
    projections (float64) and two lifts of the anchors, the combinations
    reading P, V, fa, the y-row minima and maxima, and the anchors' (3, r)
    projections and (3, g) columns."""
    n, r, g = ao.res.n, ao.fused.r, ao.fused.g_total
    chunks = -(-steps // every)
    sb, so = small_cost(ao, iters, g, nb)
    pb, po = big_pass(ao, nb)
    nbytes = (sb + chunks * (4 * pb + nb * 4 * (9 * n + 2 * n + 2 * 3 * r
                                                 + 2 * 3 * g))
              + nb * 4 * (3 * n * 2 + n) + pb)
    ops = {"float32": nb * steps * so + chunks * (2 * po + nb * 6 * 3 * n),
           "float64": (2 * chunks + 1) * po}
    return nbytes, ops


def k3_cost(ao, steps, iters, every, contact, nb=1):
    """(bytes, {dtype: ops}) of one kernel-3 (or, with ``contact = 0``,
    kernel-4) call of ``steps`` steps for ``nb`` sims, ``contact`` of
    whose sim-steps clamp: per call, when a step is free, the small
    operands (:func:`small_cost`) and the floor test's (r, N) y slice of
    the lift and each sim's y rows of b0, b1, fa, and per free sim-step
    their operations; per contact sim-step what a step of kernel 2 costs;
    per rebase a materialization of P and V and the refresh of their
    projections (float64); per call the force terms, their projection and
    the output's materialization."""
    ro = ao.res
    n, r = ro.n, ao.fused.r
    free = nb * steps - contact
    rebases = (steps - 1) // every if steps else 0
    sb, so = small_cost(ao, iters, ro.n_sel, nb)
    yb = ro.U_liftT.element_size() * r * n + nb * 4 * 3 * n
    cb, co = k2_cost(ro, contact, iters)
    pb, po = big_pass(ao, nb)
    mat_bytes = pb + nb * 4 * 15 * n   # read b0, b1, fa; write b0, b1
    nbytes = ((sb + yb if free else 0) + cb
              + rebases * (mat_bytes + pb + nb * 4 * 3 * n)
              + nb * 4 * 3 * n * 2 + pb + mat_bytes)
    ops = {"float32": free * (so + 2 * r * n) + co["float32"]
           + (rebases + 1) * 2 * po,
           "float64": co["float64"] + (rebases + 1) * (po + 2 * po)}
    return nbytes, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(v / PEAK_OPS[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def step_share(ro, fa, rb_extra, Pi, Vi, Pk, Vk, Pp, Vp):
    """{"P": (difference, size), "V": ...} of a kernel's step (Pk, Vk)
    against its plain version's step (Pp, Vp), both from (Pi, Vi).  The
    size of P's step is the smaller of its change and the lift U u within
    it (P' against the clamped predictor); that of V's step its change."""
    from animsnapbases_tpu_torch.ops.resident import predict

    sn, _ = predict(ro, Pi, Vi, fa, rb_extra)
    return {"P": (max_abs(Pk, Pp), min(max_abs(Pp, Pi), max_abs(Pp, sn))),
            "V": (max_abs(Vk, Vp), max_abs(Vp, Vi))}


def hold_step(label, shares):
    """Each difference of :func:`step_share` below STEP_TOL of its size."""
    for key, (d, s) in shares.items():
        require(d <= STEP_TOL * s,
                f"{label} {key}: differs from the plain version by {d:.3e}, "
                f"above {STEP_TOL} of the step's size {s:.3e}")


def step_by_step(torch, label, ro, run_k, run_p, P, V, Fx, rb_extra, steps,
                 run_64=None):
    """Each of ``steps`` steps as a one-step call of the kernel
    (``run_k``) and of its plain version (``run_p``), both from the
    kernel's own state, held at STEP_TOL of the step's size
    (:func:`step_share`).  ``run_64`` (optional) gives P's distance from a
    float64 step, printed and not held.  Returns the largest difference and
    the kernel's end state."""
    from animsnapbases_tpu_torch.ops.resident import force_term

    fa = force_term(ro, Fx)
    diff = {"P": 0.0, "V": 0.0}
    share = {"P": 0.0, "V": 0.0}
    size = {"P": float("inf"), "V": float("inf")}
    off64 = [0.0, 0.0]
    Pi, Vi = P, V
    for _ in range(steps):
        Pk, Vk = run_k(Pi, Vi)
        Pp, Vp = run_p(Pi, Vi)
        require(bool(torch.isfinite(Pk).all() and torch.isfinite(Vk).all()),
                f"{label}: non-finite state")
        if run_64 is not None:
            P64 = run_64(Pi, Vi)
            off64 = [max(off64[0], max_abs(Pk, P64)),
                     max(off64[1], max_abs(Pp, P64))]
        shares = step_share(ro, fa, rb_extra, Pi, Vi, Pk, Vk, Pp, Vp)
        hold_step(label, shares)
        for key, (d, s) in shares.items():
            diff[key] = max(diff[key], d)
            share[key] = max(share[key], d / s if s > 0 else 0.0)
            size[key] = min(size[key], s)
        Pi, Vi = Pk, Vk
    torch.cuda.synchronize()
    log(f"[3] {label}, {steps} steps one by one against the plain version: "
        + "; ".join(f"{key} max abs {diff[key]:.3e}, at most "
                    f"{share[key]:.3e} of the step's size (tol {STEP_TOL}), "
                    f"smallest step size {size[key]:.3e}"
                    for key in ("P", "V"))
        + (f"; largest P distance from the float64 step (not held): "
           f"kernel {off64[0]:.3e}, plain {off64[1]:.3e}"
           if run_64 is not None else ""))
    return max(diff.values()), (Pi, Vi)


def carried_steps(torch, label, kernel, ao, plain, P, V, F_, rb_extra,
                  steps):
    """The steps one call of kernel 3, 4 or 5 (``kernel``) carries inside
    it, in its coefficients over the call's anchors (P, V): for each
    s <= ``steps``, one kernel call of s steps against one plain affine
    step (``AffineContext``; through the gathered values for kernel 5) from
    the coefficients that the kernel's call of s - 1 steps left, over the
    same anchors, held at STEP_TOL of that step's size (:func:`step_share`).
    The plain step starts from the kernel's own coefficients, so what it is
    held to does not drift as s grows; and over the same anchors, so the
    bfloat16 rounding of the anchors is the same on both sides (a step from
    the materialized state would round other anchors).  Every call must
    do all its steps without a rebase or a contact step.

    At a branch step, where the loop's clamps take another branch in the
    two float32 orders and the step parts by more than STEP_TOL, the
    kernel must be as near to the float64 plain step from the same
    coefficients as the float32 plain step is, within ACC_RATIO (as
    kernel 1 is held); a kernel that carried wrong coefficients is far
    from both.

    Printed, not held: the kernel's call of s steps against the plain
    version's call (``plain``) of as many steps from (P, V), for a few s,
    which the dynamics of this scene part within a few steps."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        AffineContext,
        AffineState,
        _launch_affine,
        basis,
        split_coef,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        _chunk_cuda,
        advance,
        gathered_values,
    )
    from animsnapbases_tpu_torch.ops.resident import force_term, project

    require(steps < REBASE_EVERY, "a carried window must not rebase")
    ro = ao.res
    fa = force_term(ro, F_)
    ctx = AffineContext(ao, fa)
    gidx = ao.fused.gidx.long()
    b0s, b1s, fas = P[:, gidx], V[:, gidx], fa[:, gidx]
    bu0, bu1 = project(ro, P), project(ro, V)
    # the float64 plain step, the matrices kept in their storage type
    ro64 = dataclasses.replace(ro, fused=as_f64(ro.fused),
                               mass_inv=ro.mass_inv.double())
    ao64 = dataclasses.replace(ao, res=ro64, M_utac=ao.M_utac.double(),
                               U_selT=ao.U_selT.double())
    ctx64 = AffineContext(ao64, fa.double())

    def plain_step(cx, coefs, rb):
        """One plain affine step from ``coefs`` over the anchors (P, V) in
        the context ``cx`` -> (state before, state after), materialized."""
        dt = cx.fa.dtype
        b0, b1 = P.to(dt), V.to(dt)
        st = AffineState(b0, b1, *(c.to(dt) for c in coefs))
        before = cx.output(st)
        _, _, wp, _, avd, asn, wsn = cx.predictor(st)
        if kernel == 5:
            cols = (b0[:, gidx], b1[:, gidx], cx.fa[:, gidx])
            cx.gathered_step(st, asn, wsn, avd, wp,
                             gathered_values(cx.ao, asn, wsn, *cols), rb,
                             ITERATIONS)
        else:
            cx.free_step(st, asn, wsn, avd, wp, rb, ITERATIONS)
        return before, cx.output(st)

    def run_k(s):
        """The kernel's call of s steps -> (P', V', its coefficients)."""
        if kernel == 5:
            ymm = torch.empty(6, dtype=P.dtype, device=P.device)
            *coefs, done = _chunk_cuda(
                ao, P, V, fa, ymm, True, b0s, b1s, fas, bu0, bu1, ctx.bu_fa,
                rb_extra, s, ITERATIONS, ao.floor_level)
            Pk, Vk = advance(ao, P, V, fa, *coefs)
        else:
            Pk, Vk, flags, coef = _launch_affine(
                ao, P, V, F_, rb_extra, s, ITERATIONS, REBASE_EVERY,
                kernel == 4)
            coefs = split_coef(coef, ao.fused.r)
            done = (int(flags[2]) if kernel == 4 else
                    s - int(flags[FLAG_SLOTS:FLAG_SLOTS + s].sum()))
        require(done == s, f"{label}: the kernel did {done} of {s} "
                "contact-free steps")
        return Pk, Vk, tuple(coefs)

    e0, e1, _ = basis(P.dtype, P.device)
    zw = torch.zeros((3, ao.fused.r), dtype=P.dtype, device=P.device)
    coefs = (e0, e1, zw, zw)
    diff = {"P": 0.0, "V": 0.0}
    share = {"P": (0.0, 0), "V": (0.0, 0)}
    apart, branches = {}, []
    for s in range(1, steps + 1):
        Pk, Vk, after = run_k(s)
        (Pi, Vi), (Pp, Vp) = plain_step(ctx, coefs, rb_extra)
        shares = step_share(ro, fa, rb_extra, Pi, Vi, Pk, Vk, Pp, Vp)
        if all(d <= STEP_TOL * sz for d, sz in shares.values()):
            for key, (d, sz) in shares.items():
                diff[key] = max(diff[key], d)
                share[key] = max(share[key], (d / sz if sz > 0 else 0.0, s))
        else:
            _, (P64, V64) = plain_step(ctx64, coefs, rb_extra.double())
            near = {}
            for key, got, pl, ref in (("P", Pk, Pp, P64), ("V", Vk, Vp, V64)):
                e_k, e_p = max_abs(got, ref), max_abs(pl, ref)
                floor = F32_EPS * float(ref.abs().max())
                require(e_k <= ACC_RATIO * max(e_p, floor),
                        f"{label}, step {s} {key}: differs from the plain "
                        f"version by {shares[key][0]:.3e} (step size "
                        f"{shares[key][1]:.3e}) and is {e_k:.3e} from the "
                        f"float64 step, the plain version {e_p:.3e}")
                near[key] = (shares[key][0] / shares[key][1], e_k, e_p)
            branches.append((s, near))
        if s in (1, 2, 3, 4, steps):
            out = plain(ao, P, V, F_, rb_extra, s, ITERATIONS)
            done = out[2] if len(out) > 2 else s
            require(done == s, f"{label}: the plain version stopped after "
                    f"{done} of {s} steps")
            apart[s] = (max_abs(Pk, out[0]), max_abs(Vk, out[1]))
        coefs = after
    torch.cuda.synchronize()
    log(f"[3] {label}: calls of 1..{steps} steps, each step against a plain "
        f"step from the kernel's coefficients: " + "; ".join(
            f"{key} max abs {diff[key]:.3e}, at most {share[key][0]:.3e} of "
            f"the step's size (tol {STEP_TOL}, at step {share[key][1]})"
            for key in ("P", "V"))
        + f" on {steps - len(branches)} of {steps} steps; branch steps "
        "(share of the step's size, kernel's and plain version's distance "
        "from the float64 step, limit " + f"{ACC_RATIO}x): " + (", ".join(
            f"step {s}: " + " ".join(
                f"{key} {x:.3e} {e_k:.3e} {e_p:.3e}"
                for key, (x, e_k, e_p) in near.items())
            for s, near in branches) or "none")
        + "; the call of s steps against the plain version's call of s "
        "steps (not held): " + ", ".join(
            f"s={s}: P {p:.3e} V {v:.3e}" for s, (p, v) in apart.items()))
    return max(diff.values())


def same_as_steps(torch, label, call, P, V, Pi, Vi, steps):
    """One ``steps``-step call (``call``) must equal the ``steps`` one-step
    calls that led from (P, V) to (Pi, Vi) bit for bit."""
    P_all, V_all = call(P, V)[:2]
    torch.cuda.synchronize()
    same = bool(torch.equal(P_all, Pi) and torch.equal(V_all, Vi))
    log(f"[3] {label}: one {steps}-step call == {steps} one-step calls: "
        f"{same}")
    require(same, f"{label}: the step loop differs from repeated single "
            "steps")
    return P_all, V_all


def contact_state(model):
    """The contact scene: the bench cloth moved down so that its lowest
    vertex sits CONTACT_GAP above the floor, falling at CONTACT_SPEED."""
    P = model.init_positions.copy()
    P[:, 1] += model.floor_height + CONTACT_GAP - P[:, 1].min()
    V = np.zeros_like(P)
    V[:, 1] = -CONTACT_SPEED
    return P, V


def spy_tier1(solver):
    """Record the steps done of every tier-1 call of ``solver``."""
    calls = []
    real = solver._resident_fast

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[2])
        return out

    solver._resident_fast = spy
    return calls


def counted_path(torch, counted, label, own, run):
    """Drive one path (``run``) with every launch counter set to 0 just
    before it and read just after: each kernel named in ``own`` must have
    launched, every other kernel not at all.  Returns the path's counts."""
    for fn in counted:
        fn.launches = 0
    run()
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in counted}
    log(f"[2] launches on {label}: {counts}")
    for name, count in counts.items():
        if name in own:
            require(count > 0, f"{name} was never launched on {label}")
        else:
            require(count == 0, f"{name} was launched {count} times on "
                    f"{label}, which is not its path")
    return counts


def tiered_runs(torch, counted, solver, model, f, rest, label, tier1,
                contact):
    """The bench scene's rest state (``rest``) through run_steps(64): tier 1
    (the kernel named ``tier1``) must serve and certify the whole window;
    then the contact scene: tier 1 must exit at 0 < k < 64 and the contact
    tier (``contact``) finish the window.  Each run is a path of its own
    for the launch counters.  Returns {run: counts}."""
    calls = spy_tier1(solver)
    model.positions, model.velocities = (x.copy() for x in rest)
    frame = solver.frame
    counts = {}
    counts["bench window"] = counted_path(
        torch, counted, f"{label}, bench window", {tier1},
        lambda: solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS))
    require(calls == [SCENE_STEPS]
            and solver._last_fast_steps == SCENE_STEPS,
            f"{label}: tier 1 did not serve the whole bench window "
            f"(calls {calls}, certificate {solver._last_fast_steps})")
    model.positions, model.velocities = contact_state(model)
    counts["contact scene"] = counted_path(
        torch, counted, f"{label}, contact scene", {tier1, contact},
        lambda: solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS))
    require(len(calls) == 2 and 0 < calls[1] < SCENE_STEPS
            and solver._last_fast_steps is None
            and solver.frame == frame + 2 * SCENE_STEPS,
            f"{label}: the contact scene did not go tier 1 -> contact tier "
            f"(tier-1 steps {calls[1:]})")
    require(np.isfinite(model.positions).all()
            and model.positions[:, 1].min() > -0.5,
            f"{label}: the contact scene's state is not finite and held at "
            "the floor")
    log(f"[2] {label} ({solver._resident_fast_kind} tier 1, "
        f"{solver._resident_kind} contact tier): bench window certified "
        f"({SCENE_STEPS} steps); contact scene: tier 1 exited after "
        f"{calls[1]} steps, contact tier served {SCENE_STEPS - calls[1]}, "
        f"end y in [{model.positions[:, 1].min():.4f}, "
        f"{model.positions[:, 1].max():.4f}]")
    return counts


def reprepare(solver, **switches):
    """Set the solver's tier switches and prepare again (the host matrices
    are kept: only the tiers are rebuilt)."""
    for k, v in switches.items():
        setattr(solver, k, v)
    solver.prepare(solver.args)


def ensemble_state(main_state, B):
    """The ring-down ensemble (bench_ensemble.py's design): B copies of the
    main path's end positions, sim b moving at (1 - SPREAD b) x a tenth of
    its end velocity, no external force."""
    P0, V0 = main_state
    pos = np.repeat(P0[None], B, axis=0)
    vel = np.stack([(1.0 - SPREAD * b) * 0.1 * V0 for b in range(B)])
    return pos, vel, np.zeros_like(pos)


def contact_sims():
    """The mixed batch's sims in the contact scene: b % SIM_ROWS >=
    SIM_ROWS / 2 (the others ring down)."""
    return [b for b in range(MIXED) if b % SIM_ROWS >= SIM_ROWS // 2]


def mixed_state(model, main_state, f):
    """The mixed batch: MIXED / 2 sims of the ring-down ensemble, and as
    many in the contact scene under gravity (:func:`contact_sims`), sim j
    of them lifted CONTACT_RISE + CONTACT_STEP j more, so that each reaches
    the floor at its own step."""
    pos, vel, fs = ensemble_state(main_state, MIXED)
    for j, b in enumerate(contact_sims()):
        pos[b], vel[b] = contact_state(model)
        pos[b][:, 1] += CONTACT_RISE + CONTACT_STEP * j
        fs[b] = f
    return pos, vel, fs


def same_per_sim(torch, label, batched, solo, B):
    """Each sim of a batched call (``batched``: a tuple of tensors with a
    leading sim axis) equals the solo call from that sim's inputs
    (``solo(b)``: the same tuple without it) bit for bit."""
    diff = []
    for b in range(B):
        one = solo(b)
        diff.append(max(max_abs(x[b], y) for x, y in zip(batched, one)))
    torch.cuda.synchronize()
    log(f"[3] {label}: each of {B} sims against the solo kernel from its "
        f"state: largest difference {max(diff):.3e} (held bit for bit)")
    require(max(diff) == 0.0, f"{label}: a sim differs from the solo kernel "
            f"(differences {diff})")


def device_breakdown(torch, fn):
    """(seconds of host time, {kernel name: device seconds}) of one call of
    ``fn`` under torch.profiler, the names cut at their template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spent = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            name = ev.key.split("<")[0].replace("void ", "")
            spent[name] = spent.get(name, 0.0) + us * 1e-6
    return wall, spent


def ensemble(torch, counted, solver, model, f, main_state, paths):
    """The ensemble-serving section: the paths (2), holds (3) and times (4)
    of make_batched_run / make_batched_step and the batched builds of
    kernels 1, 2, 3 and 5.  Returns the four batched entries of the kernels
    line."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        resident_affine,
        resident_affine_batched,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        _chunk_launch,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        project,
        resident_multistep,
        resident_multistep_batched,
        resident_multistep_plain,
    )

    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    default_min = type(solver).CHUNKED_TIER1_MIN_VERTS

    # ---- 2. the ensemble paths through the entry points ----------------
    run = solver.make_batched_run()
    step = solver.make_batched_step()
    ens = ensemble_state(main_state, ENSEMBLE)
    mixed = mixed_state(model, main_state, f)
    out = {}

    def drive(key, fn):
        def go():
            t0 = time.perf_counter()
            out[key] = fn()
            torch.cuda.synchronize()
            out[key + " s"] = time.perf_counter() - t0
        return go

    label_a = f"make_batched_run, B={ENSEMBLE} ring-down"
    paths[label_a] = counted_path(
        torch, counted, f"{label_a} ({WINDOW_STEPS} steps)",
        {"resident_affine_batched"},
        drive("a", lambda: run(*ens, WINDOW_STEPS,
                               num_iterations=ITERATIONS)))
    require(solver._last_batched_path == "batched-resident",
            f"{label_a} took {solver._last_batched_path}")
    p, v = out["a"]
    require(p.shape == ens[0].shape and np.isfinite(p).all()
            and np.isfinite(v).all(), f"{label_a}: end state not finite")
    require(float(p[..., 1].min()) > model.floor_height,
            f"{label_a}: a sim reached the floor")
    entry_a = ENSEMBLE * WINDOW_STEPS / out["a s"]
    log(f"[2] {label_a}: {WINDOW_STEPS} steps in {out['a s']:.3f} s "
        f"({entry_a:.0f} aggregate steps/s, {entry_a / ENSEMBLE:.0f} per "
        f"sim, host transfers included); end state finite and floor-clear, "
        f"min y {float(p[..., 1].min()):.4f}, first and last sim "
        f"{float(np.abs(p[-1] - p[0]).max()):.3e} apart")

    label_b = f"make_batched_run, mixed batch of {MIXED}"
    paths[label_b] = counted_path(
        torch, counted, label_b, {"resident_affine_batched"},
        drive("b", lambda: run(*mixed, SCENE_STEPS,
                               num_iterations=ITERATIONS)))
    require(solver._last_batched_path == "batched-resident",
            f"{label_b} took {solver._last_batched_path}")
    p, _ = out["b"]
    contact = contact_sims()
    ring = [b for b in range(MIXED) if b not in contact]
    require(np.isfinite(p).all() and float(p[ring, :, 1].min())
            > model.floor_height and float(p[contact, :, 1].min()) > -0.5,
            f"{label_b}: not finite, or a ring-down sim at the floor, or a "
            "contact sim through it")
    log(f"[2] {label_b}: {SCENE_STEPS} steps; ring-down sims {ring} min y "
        f"{float(p[ring, :, 1].min()):.4f}, contact sims {contact} min y "
        f"{float(p[contact, :, 1].min()):.4f}")

    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=0,
              resident_rebase_every=MIXED_EVERY)
    label_c = (f"make_batched_run, mixed batch of {MIXED}, "
               "CHUNKED_TIER1_MIN_VERTS=0")
    paths[label_c] = counted_path(
        torch, counted, label_c,
        {"affine_chunked_batched", "resident_multistep_batched"},
        drive("c", lambda: run(*mixed, SCENE_STEPS,
                               num_iterations=ITERATIONS)))
    route_c = solver._last_batched_path
    require(route_c.startswith("batched-chunked+perstep[")
            and int(route_c.split("[")[1].rstrip("w]")) >= 2,
            f"{label_c}: took {route_c}, not kernel 5 -> kernel 2 windows "
            "-> kernel 5")
    p, _ = out["c"]
    require(np.isfinite(p).all() and float(p[contact, :, 1].min()) > -0.5,
            f"{label_c}: end state not finite or through the floor")
    d_bc = float(np.abs(out["b"][0] - p).max())
    log(f"[2] {label_c}: {route_c}; against the default route (not held: "
        f"other kernels in float32) max |dP| {d_bc:.3e}")

    label_d = f"make_batched_step, B={ENSEMBLE}"
    paths[label_d] = counted_path(
        torch, counted, label_d, {"fused_reduced_iterations_batched"},
        drive("d", lambda: step(*ens, num_iterations=ITERATIONS)))
    require(np.isfinite(out["d"][0]).all(), f"{label_d}: not finite")
    log(f"[2] {label_d}: one step in {1e3 * out['d s']:.1f} ms (host "
        "transfers included)")
    launch_path = {"fused_reduced_iterations_batched": label_d,
                   "resident_affine_batched": label_a,
                   "resident_multistep_batched": label_c,
                   "affine_chunked_batched": label_c}

    # ---- 3. holds --------------------------------------------------------
    rb = solver._rb_extra()
    P64, V64, F64 = (solver._pack(x) for x in ens)
    Pm, Vm, Fm = (solver._pack(x) for x in mixed)
    fo64 = as_f64(fo)

    # kernel 1 at B = 64 from the ring-down ensemble's predictor
    sn, rbc = predict(ro, P64, V64, force_term(ro, F64), rb)
    snT = sn[..., :ro.n_sel]
    u_k = fused_reduced_iterations_batched(fo, snT, rbc, ITERATIONS)
    same_per_sim(torch, f"batched kernel 1 (B={ENSEMBLE})", (u_k,),
                 lambda b: (fused_reduced_iterations(
                     fo, snT[b], rbc[b].contiguous(), ITERATIONS),),
                 ENSEMBLE)
    u_p = fused_reduced_iterations_plain(fo, snT, rbc, ITERATIONS)
    u_ps = torch.stack([fused_reduced_iterations_plain(
        fo, snT[b], rbc[b], ITERATIONS) for b in range(ENSEMBLE)])
    u_64 = fused_reduced_iterations_plain(fo64, snT.double(), rbc.double(),
                                          ITERATIONS)
    k1_err = max_abs(u_k, u_p)
    ok_k, e_k, e_p = as_accurate(u_k, u_p, u_64)
    ok_p, e_pb, e_ps = as_accurate(u_p, u_ps, u_64)
    log(f"[3] batched kernel 1: vs its plain version max abs {k1_err:.3e}; "
        f"vs float64: kernel {e_k:.3e}, batched plain {e_p:.3e}, solo plain "
        f"{e_ps:.3e} (limit {ACC_RATIO}x)")
    require(ok_k, "batched kernel 1 is less accurate than its plain version")
    require(ok_p, "the batched plain kernel 1 is less accurate than the "
            "solo plain version")

    # kernels 2 and 3: a SCENE_STEPS call on the mixed batch and on the
    # ring-down ensemble, against the solo kernel per sim
    batches = (("mixed batch", Pm, Vm, Fm, MIXED),
               (f"ring-down B={ENSEMBLE}", P64, V64, F64, ENSEMBLE))
    for label, P_, V_, F_, B in batches:
        same_per_sim(
            torch, f"batched kernel 2, {label}, {SCENE_STEPS} steps",
            resident_multistep_batched(ro, P_, V_, F_, rb, SCENE_STEPS,
                                       ITERATIONS),
            lambda b: resident_multistep(ro, P_[b], V_[b], F_[b], rb,
                                         SCENE_STEPS, ITERATIONS), B)
        for every in (REBASE_EVERY, 3):
            Pb, Vb, flb, _ = _launch_affine(ao, P_, V_, F_, rb, SCENE_STEPS,
                                            ITERATIONS, every, False)
            same_per_sim(
                torch, f"batched kernel 3, {label}, {SCENE_STEPS} steps, "
                f"rebase_every={every}", (Pb, Vb, flb),
                lambda b: _launch_affine(ao, P_[b], V_[b], F_[b], rb,
                                         SCENE_STEPS, ITERATIONS, every,
                                         False)[:3], B)
        steps_clamped = flb[:, FLAG_SLOTS:FLAG_SLOTS + SCENE_STEPS].bool()
        clamped = steps_clamped.sum(1).tolist()
        log(f"[3]   {label}: clamped steps per sim {clamped}")
        if P_ is Pm:
            require(max(clamped[b] for b in ring) == 0
                    and min(clamped[b] for b in contact) > 0,
                    "the mixed batch's contact sims did not clamp, or its "
                    "ring-down sims did")
            # steps at which two clamping sims share a block of kernel 3's
            # O(N) contact launches
            shared = sum(int((steps_clamped[b]
                              & steps_clamped[b + SIM_ROWS]).sum())
                         for b in contact if b + SIM_ROWS < MIXED)
            log(f"[3]   {label}: {shared} (sim, step) pairs with two "
                f"clamping sims on one block (sims b and b + {SIM_ROWS})")
            require(shared > 0, "no two clamping sims of the mixed batch "
                    "shared a block of batched kernel 3")
    # one step of each batched kernel against its batched plain version,
    # and of the batched plain version against the solo plain version,
    # per sim (STEP_TOL of the step's size, as the solo holds), on both
    # batches
    err = {}
    for name, kernel, plain in (
            ("kernel 2", lambda *a: resident_multistep_batched(ro, *a),
             lambda *a: resident_multistep_plain(ro, *a)),
            ("kernel 3", lambda *a: resident_affine_batched(ao, *a),
             lambda *a: resident_affine_plain(ao, *a)),
            ("kernel 5", lambda *a: affine_chunked_batched(ao, *a)[:2],
             lambda *a: affine_chunked_plain(ao, *a)[:2])):
        err[name] = 0.0
        for label, P_, V_, F_, B in batches:
            fam = force_term(ro, F_)
            Pk, Vk = kernel(P_, V_, F_, rb, 1, ITERATIONS)
            Pp, Vp = plain(P_, V_, F_, rb, 1, ITERATIONS)
            for b in range(B):
                Ps, Vs = plain(P_[b], V_[b], F_[b], rb, 1, ITERATIONS)
                shares = step_share(ro, fam[b], rb, P_[b], V_[b], Pk[b],
                                    Vk[b], Pp[b], Vp[b])
                hold_step(f"batched {name}, {label}, sim {b}", shares)
                hold_step(f"batched plain {name}, {label}, sim {b}",
                          step_share(ro, fam[b], rb, P_[b], V_[b], Pp[b],
                                     Vp[b], Ps, Vs))
                err[name] = max(err[name], *(d for d, _ in shares.values()))
        log(f"[3] batched {name}, one step of the mixed batch and of the "
            f"ring-down ensemble: kernel vs batched plain and batched plain "
            f"vs solo plain within {STEP_TOL} of each sim's step size; "
            f"kernel vs plain max abs {err[name]:.3e}")

    # kernel 5: the chunk launch against the solo chunk per sim, the
    # whole-batch k against the sims' solo tier-1 k, each sim committed to
    # exactly k steps
    gidx = fo.gidx.long()
    fa = force_term(ro, Fm)
    bu0, bu1, b0s, b1s = chunk_anchors(ao, Pm, Vm)
    fas, bufa = fa[..., gidx], project(ro, fa)
    ymm = torch.empty(MIXED, 6, device=Pm.device)
    ymm1 = torch.empty(MIXED, 6, device=Pm.device)
    chunk_in = (Pm, Vm, fa, ymm, b0s, b1s, fas, bu0, bu1, bufa)

    def launch(P_, V_, fa_, ymm_, *anchors):
        return _chunk_launch(ao, P_, V_, fa_, ymm_, True, *anchors, rb,
                             SCENE_STEPS, ITERATIONS, ao.floor_level)

    def solo_chunk(b):
        one = [x[b] for x in chunk_in]
        one[3] = ymm1[b]
        return (*launch(*one), ymm1[b])

    coef, kb = launch(*chunk_in)
    same_per_sim(torch, f"batched kernel 5 chunk, mixed batch, "
                 f"{SCENE_STEPS} steps", (coef, kb, ymm), solo_chunk, MIXED)
    ks = [affine_chunked(ao, Pm[b], Vm[b], Fm[b], rb, SCENE_STEPS,
                         ITERATIONS)[2] for b in range(MIXED)]
    Pk, Vk, k = affine_chunked_batched(ao, Pm, Vm, Fm, rb, SCENE_STEPS,
                                       ITERATIONS)
    Pp, Vp, kp = affine_chunked_plain(ao, Pm, Vm, Fm, rb, SCENE_STEPS,
                                      ITERATIONS)
    kps = [affine_chunked_plain(ao, Pm[b], Vm[b], Fm[b], rb, SCENE_STEPS,
                                ITERATIONS)[2] for b in range(MIXED)]
    log(f"[3] batched kernel 5, mixed batch: whole-batch k {k} (plain "
        f"{kp}); the sims' solo tier-1 k {ks} (plain {kps}); chunk k_b "
        f"{kb.tolist()}")
    require(k == min(ks) and 0 < k < max(ks),
            f"batched kernel 5's k {k} is not the least of the solo k {ks}")
    require(kp == min(kps), f"the batched plain kernel 5's k {kp} is not "
            f"the least of the solo plain k {kps}")
    k5_err = 0.0
    for b in range(MIXED):
        Ps, Vs, kk = affine_chunked(ao, Pm[b], Vm[b], Fm[b], rb, k,
                                    ITERATIONS)
        require(kk == k, f"sim {b} does not do {k} solo steps")
        for key, got, want, start in (("P", Pk[b], Ps, Pm[b]),
                                      ("V", Vk[b], Vs, Vm[b])):
            d, size = max_abs(got, want), max_abs(want, start)
            k5_err = max(k5_err, d)
            require(d <= STEP_TOL * size,
                    f"batched kernel 5, sim {b} {key}: {d:.3e} from its "
                    f"solo {k}-step run (change {size:.3e})")
    # (one step against the batched plain version is held above; the
    # k-step calls part as any two float32 orders do: printed, not held)
    log(f"[3] batched kernel 5: every sim committed to exactly {k} steps "
        f"(each within {STEP_TOL} of its change from its solo {k}-step run; "
        f"max abs {k5_err:.3e}); the {k}-step calls against the batched "
        f"plain version (not held) P {max_abs(Pk, Pp):.3e}, V "
        f"{max_abs(Vk, Vp):.3e}")

    # ---- 4. times --------------------------------------------------------
    F0 = torch.zeros_like(P64)
    per_step, bounds = {}, {}
    for B in ENSEMBLE_SIZES:
        Pe, Ve = (solver._pack(x) for x in ensemble_state(main_state, B)[:2])
        Fe = torch.zeros_like(Pe)
        flags = _launch_affine(ao, Pe, Ve, Fe, rb, WINDOW_STEPS, ITERATIONS,
                               REBASE_EVERY, False)[2]
        require(int(flags[:, FLAG_SLOTS:].sum()) == 0,
                f"the timed ring-down window of {B} sims is not "
                "contact-free")
        if B == 1:      # one sim serves on the solo kernel
            Pe, Ve, Fe = Pe[0], Ve[0], Fe[0]
            call = resident_affine
        else:
            call = resident_affine_batched
        per_step[B] = 1e3 * cuda_ms(torch, lambda: call(
            ao, Pe, Ve, Fe, rb, WINDOW_STEPS, ITERATIONS), reps=3,
            warmup=0) / WINDOW_STEPS
        bounds[B] = 1e3 * bound_ms(*k3_cost(
            ao, WINDOW_STEPS, ITERATIONS, REBASE_EVERY, 0, nb=B))[0] \
            / WINDOW_STEPS
        log(f"[4] batched kernel 3, B={B}, ring-down over {WINDOW_STEPS} "
            f"steps: {per_step[B]:.2f} us/step, {B / per_step[B] * 1e6:.0f} "
            f"aggregate steps/s, {1e6 / per_step[B]:.0f} per sim; bound "
            f"{bounds[B]:.4f} us/step")
    k3_ms = cuda_ms(torch, lambda: resident_affine_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    # where a batched step's time goes: device time per kernel of one
    # SCENE_STEPS call, and the share of the call the device is busy
    wall, spent = device_breakdown(torch, lambda: resident_affine_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    busy = sum(spent.values())
    log(f"[4] batched kernel 3, B={ENSEMBLE}, one {SCENE_STEPS}-step call "
        f"under torch.profiler: {1e6 * wall / SCENE_STEPS:.2f} us/step host "
        f"time, device busy {100 * busy / wall:.1f} %; device us/step: "
        + ", ".join(f"{k} {1e6 * v / SCENE_STEPS:.2f}" for k, v in sorted(
            spent.items(), key=lambda kv: -kv[1])[:8]))
    k3_plain_ms = cuda_ms(torch, lambda: resident_affine_plain(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=1)
    k3_bound, k3_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                        REBASE_EVERY, 0, nb=ENSEMBLE))

    k2_ms = cuda_ms(torch, lambda: resident_multistep_batched(
        ro, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    k2_plain_ms = cuda_ms(torch, lambda: resident_multistep_plain(
        ro, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=1)
    k2_bound, k2_by = bound_ms(*k2_cost(ro, SCENE_STEPS, ITERATIONS,
                                        nb=ENSEMBLE))
    k2_by_B = {B: 1e3 * cuda_ms(torch, lambda B=B: resident_multistep_batched(
        ro, P64[:B], V64[:B], F0[:B], rb, SCENE_STEPS, ITERATIONS), reps=10)
        / SCENE_STEPS for B in (8, ENSEMBLE)}
    # the one part a library call computes: the batch's projection and
    # lift, two torch.matmul on the stored bfloat16 matrices (the port never
    # calls them on the kernel path)
    snm = sn.to(ro.ut_acT.dtype).permute(1, 2, 0)              # (3, N, B)
    um = u_k.to(ro.U_liftT.dtype).permute(1, 0, 2)             # (3, B, r)
    part_ms = cuda_ms(torch, lambda: (torch.matmul(ro.ut_acT, snm),
                                      torch.matmul(um, ro.U_liftT)))

    k5_win = affine_chunked_batched(ao, P64, V64, F0, rb, WINDOW_STEPS,
                                    ITERATIONS)[2]
    require(k5_win == WINDOW_STEPS, f"batched kernel 5 stopped after "
            f"{k5_win} of the ring-down window's {WINDOW_STEPS} steps")
    k5_ms = cuda_ms(torch, lambda: affine_chunked_batched(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS))
    k5_window_ms = cuda_ms(torch, lambda: affine_chunked_batched(
        ao, P64, V64, F0, rb, WINDOW_STEPS, ITERATIONS), reps=3, warmup=1)
    k5_plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, P64, V64, F0, rb, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=1)
    k5_bound, k5_by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                        CHUNK_EVERY, nb=ENSEMBLE))

    k1_ms = cuda_ms(torch, lambda: fused_reduced_iterations_batched(
        fo, snT, rbc, ITERATIONS), reps=100)
    k1_plain_ms = cuda_ms(torch, lambda: fused_reduced_iterations_plain(
        fo, snT, rbc, ITERATIONS))
    k1_bound, k1_by = bound_ms(*k1_cost(fo, ro.n_sel, ITERATIONS,
                                        nb=ENSEMBLE))
    # the large-model route through the entry point (the solver is still
    # prepared with CHUNKED_TIER1_MIN_VERTS = 0): the ring-down window is
    # contact-free, so kernel 5 serves all of it
    t0 = time.perf_counter()
    run(*ens, WINDOW_STEPS, num_iterations=ITERATIONS)
    entry_c = ENSEMBLE * WINDOW_STEPS / (time.perf_counter() - t0)
    require(solver._last_batched_path == "batched-chunked",
            f"the large-model route took {solver._last_batched_path} on the "
            "ring-down window")
    step_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(*ens, num_iterations=ITERATIONS)
        step_s.append(time.perf_counter() - t0)
    log(f"[4] batched kernel 3, B={ENSEMBLE}: {1e3 * k3_ms / SCENE_STEPS:.2f}"
        f" us/step ({SCENE_STEPS}-step calls); plain "
        f"{1e3 * k3_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")
    log(f"[4] batched kernel 2: " + ", ".join(
        f"B={B} {us:.2f} us/step" for B, us in k2_by_B.items())
        + f"; plain at B={ENSEMBLE} {1e3 * k2_plain_ms / SCENE_STEPS:.1f} "
        f"us/step; bound {1e3 * k2_bound / SCENE_STEPS:.4f} us/step "
        f"({k2_by}); library part (torch.matmul projection + lift of the "
        f"batch, one step) {1e3 * part_ms:.2f} us")
    log(f"[4] batched kernel 5, B={ENSEMBLE}: {1e3 * k5_ms / SCENE_STEPS:.2f}"
        f" us/step ({SCENE_STEPS}-step calls), over {WINDOW_STEPS} steps "
        f"{1e3 * k5_window_ms / WINDOW_STEPS:.2f} us/step = "
        f"{ENSEMBLE * WINDOW_STEPS / (k5_window_ms / 1e3):.0f} aggregate "
        f"steps/s; plain {1e3 * k5_plain_ms / SCENE_STEPS:.1f} us/step; "
        f"bound {1e3 * k5_bound / SCENE_STEPS:.4f} us/step ({k5_by}); "
        f"make_batched_run on the large-model route over {WINDOW_STEPS} "
        f"steps {entry_c:.0f} aggregate steps/s, host transfers included")
    log(f"[4] batched kernel 1, B={ENSEMBLE}: {1e3 * k1_ms:.2f} us/call; "
        f"plain {1e3 * k1_plain_ms:.1f} us; bound {1e3 * k1_bound:.4f} us "
        f"({k1_by}); make_batched_step entry point "
        f"{1e3 * statistics.median(step_s):.1f} ms/step, host transfers "
        "included")
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=default_min,
              resident_rebase_every=None)

    # equals_solo_bitwise: each sim's output of a call was held bit for bit
    # against the solo kernel's (kernel 5: its chunk launch; the state it
    # commits is held at STEP_TOL against each sim's solo k-step run)
    def entry(name, source, replaces, err, ms, plain_ms, bound, by,
              bitwise=True, **extra):
        return {"name": name, "route": "cuda",
                "source": f"animsnapbases_tpu_torch/csrc/{source}",
                "replaces": f"animsnapbases_tpu/ops/{replaces}",
                "launches": paths[launch_path[name]][name],
                "launches_path": launch_path[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "sims": ENSEMBLE, "equals_solo_bitwise": bitwise, **extra}

    return [
        entry("fused_reduced_iterations_batched", "fused_reduced.cu",
              "pallas_reduced.py:393", k1_err, k1_ms, k1_plain_ms, k1_bound,
              k1_by, entry_step_ms=1e3 * statistics.median(step_s)),
        entry("resident_multistep_batched", "resident.cu",
              "pallas_resident.py:415", err["kernel 2"], k2_ms, k2_plain_ms,
              k2_bound, k2_by, steps_per_call=SCENE_STEPS,
              us_per_step_by_sims=k2_by_B,
              library_part_ms_per_step=part_ms),
        entry("resident_affine_batched", "affine.cu",
              "pallas_resident.py:558", err["kernel 3"], k3_ms, k3_plain_ms,
              k3_bound, k3_by, steps_per_call=SCENE_STEPS,
              window_us_per_step_by_sims=per_step,
              window_bound_us_per_step_by_sims=bounds,
              entry_aggregate_steps_per_s=entry_a,
              device_busy_share=busy / wall,
              device_us_per_step_by_launch={
                  k: 1e6 * v / SCENE_STEPS for k, v in spent.items()}),
        entry("affine_chunked_batched", "affine_chunked.cu",
              "pallas_resident.py:1145", err["kernel 5"], k5_ms, k5_plain_ms,
              k5_bound, k5_by, bitwise=False, chunk_equals_solo_bitwise=True,
              steps_per_call=SCENE_STEPS,
              window_aggregate_steps_per_s=(
                  ENSEMBLE * WINDOW_STEPS / (k5_window_ms / 1e3)),
              entry_aggregate_steps_per_s=entry_c,
              whole_batch_k=k, solo_k=ks,
              committed_vs_solo_max_abs=k5_err),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from animsnapbases_tpu_torch.device import resolve_device
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.ops import _build
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        _launch_affine,
        resident_affine,
        resident_affine_batched,
        resident_affine_exit,
        resident_affine_exit_plain,
        resident_affine_plain,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        advance,
        affine_chunked,
        affine_chunked_batched,
        affine_chunked_plain,
        chunk_anchors,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import (
        fused_reduced_iterations,
        fused_reduced_iterations_batched,
        fused_reduced_iterations_plain,
    )
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        predict,
        resident_multistep,
        resident_multistep_batched,
        resident_multistep_plain,
    )
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver,
    )

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    counted = (fused_reduced_iterations, resident_multistep, resident_affine,
               resident_affine_exit, affine_chunked,
               fused_reduced_iterations_batched, resident_multistep_batched,
               resident_affine_batched, affine_chunked_batched)

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
    model, solver = bench_solver(torch, dev)
    rest = (model.positions.copy(), model.velocities.copy())
    ro = solver._resident
    ao = solver._affine
    fo = ro.fused
    log(f"[2] prepare {time.perf_counter() - t0:.1f} s: N={ro.n} r={fo.r} "
        f"n_sel={ro.n_sel} g_total={fo.g_total} m_total={fo.m_total} "
        f"storage={ro.ut_acT.dtype}; tiers: {solver._resident_fast_kind} "
        f"tier 1, {solver._resident_kind} contact tier")
    f = gravity(model)
    main_in = []          # the state run_steps starts from on the main path

    def main_path():
        solver.step(f, num_iterations=ITERATIONS)
        main_in.extend((model.positions.copy(), model.velocities.copy()))
        solver.run_steps(f, SCENE_STEPS, num_iterations=ITERATIONS)

    t0 = time.perf_counter()
    paths = {"main path": counted_path(
        torch, counted, f"the main path (step + run_steps({SCENE_STEPS}))",
        {"fused_reduced_iterations", "affine_chunked"}, main_path)}
    require(solver._last_fast_steps == SCENE_STEPS,
            f"tier 1 did not certify the {SCENE_STEPS}-step window "
            f"({solver._last_fast_steps})")
    log(f"[2] step + run_steps({SCENE_STEPS}) "
        f"{time.perf_counter() - t0:.2f} s, tier 1 certified the window")
    require(model.positions.shape == (ro.n, 3), "state shape")
    require(np.isfinite(model.positions).all(), "non-finite positions")
    require(np.isfinite(model.velocities).all(), "non-finite velocities")
    log(f"[2] state finite; y in [{model.positions[:, 1].min():.4f}, "
        f"{model.positions[:, 1].max():.4f}], "
        f"|v|max {np.abs(model.velocities).max():.4f}")
    main_state = (model.positions.copy(), model.velocities.copy())
    t0 = time.perf_counter()
    for label, switches, tier1, contact in (
            ("default tiers", {}, "affine_chunked", "resident_affine"),
            ("resident_chunked_tier1=False",
             {"resident_chunked_tier1": False}, "resident_affine_exit",
             "resident_affine"),
            ("CHUNKED_TIER1_MIN_VERTS=0",
             {"resident_chunked_tier1": True, "CHUNKED_TIER1_MIN_VERTS": 0},
             "affine_chunked", "resident_multistep")):
        if switches:
            reprepare(solver, **switches)
        for run, counts in tiered_runs(torch, counted, solver, model, f,
                                       rest, label, tier1, contact).items():
            paths[f"{label}, {run}"] = counts
    log(f"[2] tiered runs {time.perf_counter() - t0:.1f} s")
    # the launches of each kernel in the kernels line: those of the path
    # that serves it (kernels 1 and 5: the main path; 3: the default
    # tiers' contact tier; 4: tier 1 with resident_chunked_tier1=False; 2:
    # the contact tier at >= CHUNKED_TIER1_MIN_VERTS)
    launch_path = {
        "fused_reduced_iterations": "main path",
        "affine_chunked": "main path",
        "resident_affine": "default tiers, contact scene",
        "resident_affine_exit": "resident_chunked_tier1=False, bench window",
        "resident_multistep": "CHUNKED_TIER1_MIN_VERTS=0, contact scene"}
    reprepare(solver, CHUNKED_TIER1_MIN_VERTS=type(
        solver).CHUNKED_TIER1_MIN_VERTS)
    ro, ao = solver._resident, solver._affine
    fo = ro.fused
    model.positions, model.velocities = (x.copy() for x in main_state)

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
    for label, r_ops in (("bfloat16", ro), ("float32", ro_f32)):
        # float64 plain version with the matrices in their storage type, so
        # that it rounds sn and u to it where the float32 versions do;
        # printed, not held (see STEP_TOL)
        ro64 = dataclasses.replace(r_ops, fused=fo64,
                                   mass_inv=r_ops.mass_inv.double())
        k2_err[label], (Pi, Vi) = step_by_step(
            torch, f"kernel 2 ({label} storage)", r_ops,
            lambda P_, V_, o=r_ops: resident_multistep(
                o, P_, V_, Fx, rb_extra, 1, ITERATIONS),
            lambda P_, V_, o=r_ops: resident_multistep_plain(
                o, P_, V_, Fx, rb_extra, 1, ITERATIONS),
            P, V, Fx, rb_extra, SCENE_STEPS,
            run_64=lambda P_, V_, o=ro64: resident_multistep_plain(
                o, P_.double(), V_.double(), Fx.double(), rb_extra.double(),
                1, ITERATIONS)[0])
        P_all, V_all = same_as_steps(
            torch, f"kernel 2 ({label} storage)",
            lambda P_, V_, o=r_ops: resident_multistep(
                o, P_, V_, Fx, rb_extra, SCENE_STEPS, ITERATIONS),
            P, V, Pi, Vi, SCENE_STEPS)
        Pp, Vp = resident_multistep_plain(r_ops, P, V, Fx, rb_extra,
                                          SCENE_STEPS, ITERATIONS)
        log(f"[3]   free {SCENE_STEPS}-step run, kernel vs plain (not held "
            f"to a tolerance): P {max_abs(P_all, Pp):.3e}, "
            f"V {max_abs(V_all, Vp):.3e}")

    # kernels 3, 4, 5: each step as a one-step call against the plain
    # version from the same state (STEP_TOL), on contact-free steps (the
    # tier-1 window that bench.py times: no external force, from the main
    # path's end state at a tenth of its velocity) and, for kernel 3, on the
    # bench scene falling under gravity until it reaches the floor.  One
    # call of SCENE_STEPS steps with a rebase (a chunk, for kernel 5) after
    # every step must equal the one-step calls bit for bit, which holds the
    # rebase path as well.
    Pw, Vw = P, 0.1 * V
    F0 = torch.zeros_like(Fx)
    Pc, Vc = (solver._to_device(x) for x in contact_state(model))

    def one(fn, F_, **kw):
        def run(P_, V_):
            out = fn(ao, P_, V_, F_, rb_extra, 1, ITERATIONS, **kw)
            require(len(out) == 2 or out[2] == 1,
                    f"{fn.__name__} stopped on a contact-free step")
            return out[:2]
        return run

    affine_err = {}
    for label, fn, plain, scenes in (
            ("kernel 5", affine_chunked, affine_chunked_plain,
             ((Pw, Vw, F0, "window"),)),
            ("kernel 4", resident_affine_exit, resident_affine_exit_plain,
             ((Pw, Vw, F0, "window"),)),
            ("kernel 3", resident_affine, resident_affine_plain,
             ((Pw, Vw, F0, "window"), (P, V, Fx, "falling")))):
        errs = []
        for P0, V0, F_, scene in scenes:
            err, (Pi, Vi) = step_by_step(
                torch, f"{label} ({scene} scene)", ro, one(fn, F_),
                one(plain, F_), P0, V0, F_, rb_extra, SCENE_STEPS)
            same_as_steps(
                torch, f"{label} ({scene} scene, rebase_every=1)",
                lambda P_, V_, F_=F_: fn(ao, P_, V_, F_, rb_extra,
                                         SCENE_STEPS, ITERATIONS,
                                         rebase_every=1),
                P0, V0, Pi, Vi, SCENE_STEPS)
            errs.append(err)
        affine_err[label] = max(errs)
    # the steps one call carries inside it (kernel 5's coefficients within
    # a chunk, kernels 3 and 4 between rebases), each held against a plain
    # step from the kernel's own coefficients (:func:`carried_steps`): over
    # the main path's own run_steps window (kernel 5 as the main path ran
    # it: one chunk of 64 steps under gravity) and over the tier-1 window.
    # A rebase or a chunk's end re-anchors at the materialized state; that
    # is held by the one-step calls and the rebase_every=1 calls above.
    Pm, Vm = (solver._to_device(x) for x in main_in)
    for kernel, plain, P0, V0, F_, scene in (
            (5, affine_chunked_plain, Pm, Vm, Fx,
             "main path's run_steps window"),
            (5, affine_chunked_plain, Pw, Vw, F0, "window scene"),
            (4, resident_affine_exit_plain, Pw, Vw, F0, "window scene"),
            (3, resident_affine_plain, Pw, Vw, F0, "window scene")):
        label = f"kernel {kernel}"
        err = carried_steps(torch, f"{label} ({scene}), carried steps",
                            kernel, ao, plain, P0, V0, F_, rb_extra,
                            SCENE_STEPS)
        affine_err[label] = max(affine_err[label], err)
    # how many of the falling scene's steps clamped
    Pi, Vi, n_fall = P, V, 0
    for _ in range(SCENE_STEPS):
        Pi, Vi, flags, _ = _launch_affine(ao, Pi, Vi, Fx, rb_extra, 1,
                                          ITERATIONS, REBASE_EVERY, False)
        n_fall += int(flags[FLAG_SLOTS])
    log(f"[3] kernel 3 (falling scene): {n_fall} of its "
        f"{SCENE_STEPS} steps clamped")

    # the contact scene's steps, one by one: a clamped step of kernel 3
    # (its contact tail) must equal kernel 2's step from the same state bit
    # for bit; a free step must be within STEP_TOL of the plain version's
    # step.  On clamped steps kernel 3 against its plain version is
    # printed, not held: while the cloth crumples on the floor the loop's
    # clamps branch differently in two float32 orders at some states
    # (kernel 2 against its plain version parts there by the same
    # amounts); both are printed beside their distance from the float64
    # step.
    ro64 = dataclasses.replace(ro, fused=fo64, mass_inv=ro.mass_inv.double())
    fa = force_term(ro, Fx)

    def held_contact_step(label, Pi, Vi):
        """One kernel-3 step from (Pi, Vi), held as above -> (P', V',
        clamped, its share of the plain version's step size, the plain
        version's P')."""
        P3, V3, flags, _ = _launch_affine(ao, Pi, Vi, Fx, rb_extra, 1,
                                          ITERATIONS, REBASE_EVERY, False)
        Pp, Vp = resident_affine_plain(ao, Pi, Vi, Fx, rb_extra, 1,
                                       ITERATIONS)
        shares = step_share(ro, fa, rb_extra, Pi, Vi, P3, V3, Pp, Vp)
        clamped = bool(int(flags[FLAG_SLOTS]))
        if clamped:
            P2, V2 = resident_multistep(ro, Pi, Vi, Fx, rb_extra, 1,
                                        ITERATIONS)
            require(bool(torch.equal(P3, P2) and torch.equal(V3, V2)),
                    f"{label}: a clamped step of kernel 3 differs from "
                    "kernel 2's step")
        else:
            hold_step(f"{label}, a free step of kernel 3", shares)
        share = max(d / s if s > 0 else 0.0 for d, s in shares.values())
        return P3, V3, clamped, share, Pp

    Pi, Vi = Pc, Vc
    n_contact, within, share_max, free_max = 0, 0, 0.0, 0.0
    off64, nearer = [0.0, 0.0], 0
    for _ in range(SCENE_STEPS):
        P3, V3, clamped, share, Pp = held_contact_step("contact scene", Pi,
                                                       Vi)
        P64, _ = resident_multistep_plain(ro64, Pi.double(), Vi.double(),
                                          Fx.double(), rb_extra.double(), 1,
                                          ITERATIONS)
        d64 = (max_abs(P3, P64), max_abs(Pp, P64))
        off64 = [max(off64[0], d64[0]), max(off64[1], d64[1])]
        nearer += d64[0] <= d64[1]
        n_contact += clamped
        within += share <= STEP_TOL
        share_max = max(share_max, share)
        if not clamped:
            free_max = max(free_max, share)
        Pi, Vi = P3, V3
    torch.cuda.synchronize()
    log(f"[3] kernel 3 (contact scene): {n_contact} of {SCENE_STEPS} steps "
        f"clamped, each equal to kernel 2's step bit for bit; its "
        f"{SCENE_STEPS - n_contact} free steps within {STEP_TOL} of the "
        f"plain version's step size (held), at most {free_max:.3e} of it; "
        f"over all steps against the plain version within {STEP_TOL} on "
        f"{within} of {SCENE_STEPS}, at most {share_max:.3e} (not held on "
        f"clamped steps); P distance from the float64 step: kernel at most "
        f"{off64[0]:.3e}, plain at most {off64[1]:.3e}, the kernel as near "
        f"or nearer on {nearer} of {SCENE_STEPS} steps")
    require(n_contact > 0, "no step of the contact scene clamped")
    same_as_steps(torch, "kernel 3 (contact scene, rebase_every=1)",
                  lambda P_, V_: resident_affine(ao, P_, V_, Fx, rb_extra,
                                                 SCENE_STEPS, ITERATIONS,
                                                 rebase_every=1),
                  Pc, Vc, Pi, Vi, SCENE_STEPS)
    # the tier-1 kernels on the contact scene: the same steps done, and the
    # committed state within STEP_TOL of the committed change; then the
    # hand-over: kernel 3's first step from the state tier 1 committed,
    # held as the contact scene's steps are
    for label, fn, plain in (
            ("kernel 5", affine_chunked, affine_chunked_plain),
            ("kernel 4", resident_affine_exit, resident_affine_exit_plain)):
        Pk, Vk, kk = fn(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS,
                        rebase_every=16)
        Pp, Vp, kp = plain(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS,
                           ITERATIONS, rebase_every=16)
        dP, dV = max_abs(Pk, Pp), max_abs(Vk, Vp)
        sP, sV = max_abs(Pp, Pc), max_abs(Vp, Vc)
        log(f"[3] {label} (contact scene, rebase_every=16): steps done "
            f"kernel {kk}, plain {kp}; committed state vs plain: P {dP:.3e} "
            f"of a change {sP:.3e}, V {dV:.3e} of a change {sV:.3e}")
        require(kk == kp and 0 < kk < SCENE_STEPS,
                f"{label}: steps done differ on the contact scene")
        require(dP <= STEP_TOL * sP and dV <= STEP_TOL * sV,
                f"{label}: committed contact-scene state differs")
        affine_err[label] = max(affine_err[label], dP, dV)
        _, _, clamped, share, _ = held_contact_step(
            f"hand-over from {label}", Pk, Vk)
        log(f"[3] hand-over from {label} to kernel 3 after {kk} steps: its "
            + ("first step clamped, equal to kernel 2's step bit for bit"
               if clamped else f"first step free, {share:.3e} of the plain "
               f"version's step size (tol {STEP_TOL})"))

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
        f"{WINDOW_STEPS / (window_ms / 1e3):.0f} steps/s")
    log(f"[4] library part (torch.matmul projection + lift, one step): "
        f"{1e3 * part_ms:.2f} us")

    # the tier-1 window (phase 3) over WINDOW_STEPS: contact-free, the
    # tier-1 kernels must complete every step
    k = affine_chunked(ao, Pw, Vw, F0, rb_extra, WINDOW_STEPS, ITERATIONS)[2]
    require(k == WINDOW_STEPS, f"the {WINDOW_STEPS}-step window is not "
            f"contact-free (kernel 5 stopped after {k} steps)")

    def k5(steps, iters=ITERATIONS):
        return lambda: affine_chunked(ao, Pw, Vw, F0, rb_extra, steps, iters)

    k5_ms = cuda_ms(torch, k5(SCENE_STEPS))
    k5_window_ms = cuda_ms(torch, k5(WINDOW_STEPS), warmup=1)
    k5_at = {it: cuda_ms(torch, k5(SCENE_STEPS, it)) for it in (0, 20)}
    k5_plain_ms = cuda_ms(torch, lambda: affine_chunked_plain(
        ao, Pw, Vw, F0, rb_extra, SCENE_STEPS, ITERATIONS), reps=PLAIN_REPS,
        warmup=1)
    k5_bound, k5_by = bound_ms(*k5_cost(ao, SCENE_STEPS, ITERATIONS,
                                        CHUNK_EVERY))
    k5_wbound, _ = bound_ms(*k5_cost(ao, WINDOW_STEPS, ITERATIONS,
                                     CHUNK_EVERY))
    # the outer loop's work between two chunks: the anchors' projections and
    # gathered columns, and the two lifts that materialize the chunk's end
    fa0 = force_term(ro, F0)
    ap = av = torch.eye(3, device=dev)
    wp = wv = torch.zeros(3, fo.r, device=dev)
    outer_ms = cuda_ms(torch, lambda: (chunk_anchors(ao, Pw, Vw),
                                        advance(ao, Pw, Vw, fa0, ap, av, wp,
                                                wv)))
    # the exact floor check on its own: the same call with the bound made
    # to trip on every step after the first (a huge Cauchy-Schwarz
    # constant) and a floor below every vertex, so that each exact check
    # runs and clears
    ao_trip = dataclasses.replace(ao, umax=1e18, res=dataclasses.replace(
        ro, floor_h=-1e3))
    k5_trip_ms = cuda_ms(torch, lambda: affine_chunked(
        ao_trip, Pw, Vw, F0, rb_extra, SCENE_STEPS, ITERATIONS))
    exact_us = 1e3 * (k5_trip_ms - k5_ms) / (SCENE_STEPS - 1)
    slope = 1e3 * (k5_at[20] - k5_at[0]) / (20 * SCENE_STEPS)
    log(f"[4] kernel 5: {1e3 * k5_ms / SCENE_STEPS:.2f} us/step "
        f"({k5_ms:.3f} ms per {SCENE_STEPS}-step call); over "
        f"{WINDOW_STEPS} steps {1e3 * k5_window_ms / WINDOW_STEPS:.2f} us/"
        f"step = {WINDOW_STEPS / (k5_window_ms / 1e3):.0f} steps/s; plain "
        f"{1e3 * k5_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k5_bound / SCENE_STEPS:.4f} us/step ({k5_by}), "
        f"{1e3 * k5_wbound / WINDOW_STEPS:.4f} us/step over {WINDOW_STEPS}")
    log(f"[4] kernel 5 by iterations ({SCENE_STEPS}-step calls): 0: "
        f"{1e3 * k5_at[0] / SCENE_STEPS:.2f} us/step, 20: "
        f"{1e3 * k5_at[20] / SCENE_STEPS:.2f} us/step; slope {slope:.3f} "
        f"us/iteration, intercept {1e3 * k5_at[0] / SCENE_STEPS:.2f} us/"
        f"step; outer loop between chunks {1e3 * outer_ms:.1f} us per "
        f"chunk; with the exact check on every step "
        f"{1e3 * k5_trip_ms / SCENE_STEPS:.2f} us/step, so the exact check "
        f"costs {exact_us:.2f} us")

    def affine_call(fn, P_, V_, F_):
        return lambda: fn(ao, P_, V_, F_, rb_extra, SCENE_STEPS, ITERATIONS)

    k3_ms = cuda_ms(torch, affine_call(resident_affine, Pw, Vw, F0))
    k4_ms = cuda_ms(torch, affine_call(resident_affine_exit, Pw, Vw, F0))
    require(resident_affine_exit(ao, Pw, Vw, F0, rb_extra, SCENE_STEPS,
                                 ITERATIONS)[2] == SCENE_STEPS,
            "kernel 4 stopped in the contact-free window")
    k3_plain_ms = cuda_ms(torch, affine_call(resident_affine_plain, Pw, Vw,
                                             F0), reps=PLAIN_REPS, warmup=1)
    k4_plain_ms = cuda_ms(torch, affine_call(resident_affine_exit_plain, Pw,
                                             Vw, F0), reps=PLAIN_REPS,
                          warmup=1)
    k3_bound, k3_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                        REBASE_EVERY, 0))
    # the contact scene's window: how many of its steps clamp, kernel 3's
    # time on it beside kernel 2's on the same steps
    flags = _launch_affine(ao, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS,
                           REBASE_EVERY, False)[2]
    n_contact = int(flags[FLAG_SLOTS:].sum())   # in one call, as timed
    k3c_ms = cuda_ms(torch, affine_call(resident_affine, Pc, Vc, Fx))
    k2c_ms = cuda_ms(torch, lambda: resident_multistep(
        ro, Pc, Vc, Fx, rb_extra, SCENE_STEPS, ITERATIONS))
    k3c_bound, k3c_by = bound_ms(*k3_cost(ao, SCENE_STEPS, ITERATIONS,
                                          REBASE_EVERY, n_contact))
    log(f"[4] kernel 3, free steps: {1e3 * k3_ms / SCENE_STEPS:.2f} us/step "
        f"({k3_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k3_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")
    log(f"[4] contact scene, {n_contact} of {SCENE_STEPS} steps clamp: "
        f"kernel 3 {1e3 * k3c_ms / SCENE_STEPS:.2f} us/step (bound "
        f"{1e3 * k3c_bound / SCENE_STEPS:.4f}, {k3c_by}); kernel 2 on the "
        f"same steps {1e3 * k2c_ms / SCENE_STEPS:.2f} us/step")
    log(f"[4] kernel 4: {1e3 * k4_ms / SCENE_STEPS:.2f} us/step "
        f"({k4_ms:.3f} ms per {SCENE_STEPS}-step call); plain "
        f"{1e3 * k4_plain_ms / SCENE_STEPS:.1f} us/step; bound "
        f"{1e3 * k3_bound / SCENE_STEPS:.4f} us/step ({k3_by})")

    # the entry point over the same window, host transfers included
    model.positions = solver._to_host(Pw)
    model.velocities = solver._to_host(Vw)
    f0 = np.zeros_like(f)
    solver.run_steps(f0, SCENE_STEPS, num_iterations=ITERATIONS)  # warm-up
    model.positions = solver._to_host(Pw)
    model.velocities = solver._to_host(Vw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(f0, WINDOW_STEPS, num_iterations=ITERATIONS)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    require(np.isfinite(model.positions).all(), "non-finite window state")
    require(solver._last_fast_steps == WINDOW_STEPS,
            "tier 1 did not certify the entry point's window")
    log(f"[4] run_steps entry point over {WINDOW_STEPS} steps on tier 1 "
        f"(certified): {WINDOW_STEPS / entry_s:.0f} steps/s")

    # ---- 5. kernel list and result -------------------------------------
    def entry(name, source, replaces, err, ms, plain_ms, bound, by, **extra):
        return {"name": name, "route": "cuda",
                "source": f"animsnapbases_tpu_torch/csrc/{source}",
                "replaces": f"animsnapbases_tpu/ops/{replaces}",
                "launches": paths[launch_path[name]][name],
                "launches_path": launch_path[name],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None, **extra}

    kernels = [
        entry("fused_reduced_iterations", "fused_reduced.cu",
              "pallas_reduced.py:393", k1_abs, k1_ms, k1_plain_ms, k1_bound,
              k1_by),
        entry("resident_multistep", "resident.cu", "pallas_resident.py:415",
              k2_err["bfloat16"], k2_ms, k2_plain_ms, k2_bound, k2_by,
              steps_per_call=SCENE_STEPS,
              library_part_ms_per_step=part_ms,
              window_steps_per_s=WINDOW_STEPS / (window_ms / 1e3),
              contact_scene_ms=k2c_ms),
        entry("resident_affine", "affine.cu", "pallas_resident.py:558",
              affine_err["kernel 3"], k3_ms, k3_plain_ms, k3_bound, k3_by,
              steps_per_call=SCENE_STEPS, contact_scene_ms=k3c_ms,
              contact_scene_clamped_steps=n_contact,
              contact_scene_bound_ms=k3c_bound),
        entry("resident_affine_exit", "affine.cu", "pallas_resident.py:980",
              affine_err["kernel 4"], k4_ms, k4_plain_ms, k3_bound, k3_by,
              steps_per_call=SCENE_STEPS),
        entry("affine_chunked", "affine_chunked.cu",
              "pallas_resident.py:1145", affine_err["kernel 5"], k5_ms,
              k5_plain_ms, k5_bound, k5_by, steps_per_call=SCENE_STEPS,
              window_steps_per_s=WINDOW_STEPS / (k5_window_ms / 1e3),
              us_per_iteration=slope,
              intercept_us_per_step=1e3 * k5_at[0] / SCENE_STEPS,
              outer_loop_ms_per_chunk=outer_ms,
              exact_check_us=exact_us,
              entry_steps_per_s=WINDOW_STEPS / entry_s),
    ]
    # ---- ensemble serving: paths, holds and times ----------------------
    t0 = time.perf_counter()
    kernels += ensemble(torch, counted, solver, model, f, main_state, paths)
    log(f"[2-4] ensemble serving {time.perf_counter() - t0:.1f} s")
    log(f"[5] launches per path: {json.dumps(paths)}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
