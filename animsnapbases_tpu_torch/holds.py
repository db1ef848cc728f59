"""The holds of a kernel against its plain version, step by step.

The rules by which ``chip_smoke.py`` and the smoke battery
(``animsnapbases_tpu_torch/smoke.py``) hold each hand-written kernel on
the card against its plain PyTorch version: :func:`as_accurate` (a result
against float64, within ``ACC_RATIO`` of the plain version's error),
:func:`hold_step` over :func:`step_share` (a step's difference within
``STEP_TOL`` of the step's own size), :func:`step_by_step` (one-step calls)
and :func:`carried_steps` (the steps one call of kernel 3, 4 or 5 carries
inside it).  A failed hold raises ``RuntimeError`` through
:func:`require`.  One copy serves both callers; ``chip_smoke.py`` imports
these names back.
"""

from __future__ import annotations

import dataclasses
import statistics

# kernel 1 vs its plain version on the card: both run in float32 from the
# same inputs and are held against the float64 plain result from those
# inputs.  Their float32 errors are of one size (the same arithmetic in
# another order); the kernel fails when its error exceeds ACC_RATIO times
# the plain version's.
ACC_RATIO = 4.0
F32_EPS = 2.0 ** -23
# contact mode's branch steps (:func:`carried_steps`): the float64 step
# from the kernel's input moved at random by one float32 unit, this many
# draws in one batched step, is printed beside each
WITNESS_DRAWS = 64
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
# the solver's in-kernel rebase cadence of kernels 3 and 4
REBASE_EVERY = 256


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"hold failed: {what}")


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
                  steps, every=REBASE_EVERY, options=None, batch=None, *,
                  iterations):
    """The steps one call of kernel 3, 4 or 5 (``kernel``; "3c" for kernel
    3's contact-mode build, "4b" for kernel 4's batched build on the sims
    of ``batch`` = (P, V, F, b), held on its sim b, whose state is P, V,
    F_) carries inside it, in its coefficients over the
    call's anchors (P, V): for each s <= ``steps``, one kernel call of s
    steps against one plain step (``AffineContext``; through the gathered
    values for kernel 5) from the state that the kernel's call of s - 1
    steps left, over the same anchors, held at STEP_TOL of that step's size
    (:func:`step_share`).  The plain step starts from the kernel's own
    coefficients (and, for "3c", its contact mode and y state: Py, Vy,
    buPy, buVy), so what it is held to does not drift as s grows; and over
    the same anchors, so the bfloat16 rounding of the anchors is the same
    on both sides (a step from the materialized state would round other
    anchors).  Calls of kernels 3, 4 and 5 must do all their steps without
    a rebase or a contact step.  Kernel "3c" may enter contact mode, and
    rebases every ``every`` steps: a rebase before step s re-anchors at the
    state the call of s - 1 steps returned (the same materialization,
    bit for bit), so the plain step then starts from those anchors.

    At a branch step, where the loop's clamps take another branch in the
    two float32 orders and the step parts by more than STEP_TOL, kernels
    3, 4 and 5 must be as near to the float64 plain step from the same
    state as the float32 plain step is, within ACC_RATIO (as kernel 1 is
    held); a kernel that carried a wrong state is far from both.

    In contact mode the loop branches on a third of the contact scene's
    steps, and which of two float32 orders lands nearer the float64 step
    is a coin's toss (either is the farther by more than ACC_RATIO on
    some steps).  There every step is held in two parts.  Everything but
    the loop: the kernel's step against the plain step given the kernel's
    own loop answer u (recovered from its coefficients), at STEP_TOL of
    that step's size, the carried y state with it (buPy, buVy within
    STEP_TOL of their change in the step; the contact mode equal): the
    predictor, the clamp, pc, the recursions, the lift, the coefficient
    update and the mixed output.  The loop (iteration.cuh, kernel 1's,
    held against float64 on its own): over the window's branch steps the
    kernel's distance from the float64 step, in the median and at most,
    within ACC_RATIO of the plain version's.  Printed at each branch
    step: the farthest float64 step from the same state with its
    coefficients and y state moved at random by one float32 unit
    (WITNESS_DRAWS draws), and on how many steps each float32 order lies
    beyond ACC_RATIO of it.

    Printed, not held: the kernel's call of s steps against the plain
    version's call (``plain``) of as many steps from (P, V), for a few s,
    which the dynamics of this scene part within a few steps.  ``options``
    (kernel 5 only) selects its build (ops/affine_chunked.py ChunkOptions;
    None: the default): without ``fold_vc`` its plain step takes the
    gathered values through ``U_selT`` as kernels 3 and 4 do.  With a
    target-term schedule ``rb_extra`` ((T, 3, r), animated targets) step s
    of the plain side takes the schedule's row min(s - 1, T - 1), as the
    kernel's step s does.  Returns the largest difference and the flags of
    the call of ``steps`` steps."""
    from animsnapbases_tpu_torch.ops.affine import (
        FLAG_SLOTS,
        MODE_SLOT,
        AffineContext,
        AffineState,
        _launch_affine,
        _rebase_due,
        basis,
        split_coef,
    )
    from animsnapbases_tpu_torch.ops.affine_chunked import (
        DEFAULT_OPTIONS,
        _chunk_cuda,
        advance,
        fill_ymm,
        gathered_values,
    )
    from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc
    from animsnapbases_tpu_torch.ops.resident import (
        force_term,
        project,
        rb_at,
    )

    class GivenU(AffineContext):
        """The plain step with the loop's answer given (``self.u``)."""

        def solve(self, Vc, rb_const, num_iterations):
            return self.u

    contact = kernel == "3c"
    require(contact or steps < every, "a carried window must not rebase")
    ro = ao.res
    fa = force_term(ro, F_)
    ctx = AffineContext(ao, fa)
    given = GivenU(ao, fa, ctx.bu_fa)
    options = options or DEFAULT_OPTIONS
    fold = kernel == 5 and options.fold_vc
    b0s, b1s, fas = ((gather_vc(ao.fused, x) for x in (P, V, fa)) if fold
                     else (None, None, None))
    bu0, bu1 = project(ro, P), project(ro, V)
    # the float64 plain step, the matrices kept in their storage type
    ro64 = dataclasses.replace(ro, fused=as_f64(ro.fused),
                               mass_inv=ro.mass_inv.double())
    ao64 = dataclasses.replace(ao, res=ro64, M_utac=ao.M_utac.double(),
                               U_selT=ao.U_selT.double())
    ctx64 = AffineContext(ao64, fa.double())

    def plain_step(cx, state, rb):
        """One plain step from ``state`` (anchors, coefficients, contact
        mode and y state; each may carry a leading axis of draws) in the
        context ``cx`` -> (state before, state after), materialized, and
        in contact mode the y state after (Py, Vy, buPy, buVy) when the
        step ends in the mode, else None."""
        (b0, b1), coefs, mode, y = state
        dt = cx.fa.dtype
        st = AffineState(b0.to(dt), b1.to(dt), *(c.to(dt) for c in coefs))
        before = cx.output(st)
        if contact:
            cx.init_contact(st)
            if mode:
                st.mode = torch.ones_like(st.mode)
                st.Py, st.Vy, st.buPy, st.buVy = (t.to(dt) for t in y)
            cx.step(st, rb, iterations)
            return before, cx.output(st), (
                (st.Py, st.Vy, st.buPy, st.buVy) if bool(st.mode.all())
                else None)
        _, _, wp, _, avd, asn, wsn = cx.predictor(st)
        if fold:
            cols = (gather_vc(cx.fo, st.b0), gather_vc(cx.fo, st.b1),
                    gather_vc(cx.fo, cx.fa))
            cx.gathered_step(st, asn, wsn, avd, wp,
                             gathered_values(cx.ao, asn, wsn, *cols), rb,
                             iterations)
        else:
            cx.free_step(st, asn, wsn, avd, wp, rb, iterations)
        return before, cx.output(st), None

    def run_k(s):
        """The kernel's call of s steps -> (P', V', its coefficients,
        contact mode, y state, flags)."""
        mode, y, flags = False, None, None
        if kernel == 5:
            ymm = torch.empty(6, dtype=P.dtype, device=P.device)
            if not options.floor_exact:
                fill_ymm(ymm, P, V, fa, True)
            *coefs, done = _chunk_cuda(
                ao, P, V, fa, ymm, True, b0s, b1s, fas, bu0, bu1, ctx.bu_fa,
                rb_extra, s, iterations, ao.floor_level, options)
            Pk, Vk = advance(ao, P, V, fa, *coefs)
        else:
            variant = {3: "lean", 4: "exit", "4b": "exit",
                       "3c": "contact"}[kernel]
            if batch is None:
                Pk, Vk, flags, coef, y = _launch_affine(
                    ao, P, V, F_, rb_extra, s, iterations, every, variant)
            else:
                *sims, b = batch
                Pk, Vk, flags, coef = (x[b] for x in _launch_affine(
                    ao, *sims, rb_extra, s, iterations, every, variant)[:4])
                y = None
            coefs = split_coef(coef, ao.fused.r)
            mode = bool(int(flags[MODE_SLOT]))
            done = (int(flags[2]) if kernel in (4, "4b") else s if contact
                    else s - int(flags[FLAG_SLOTS:FLAG_SLOTS + s].sum()))
        require(done == s, f"{label}: the kernel did {done} of {s} "
                "contact-free steps")
        return Pk, Vk, (tuple(coefs), mode, y), flags

    def given_u(s, state, after, Pk, Vk, rb):
        """The kernel's step against the plain step from ``state`` given
        the kernel's u (its wp after the step less the predictor's), the
        y state with it -> the largest share of a step's size."""
        anchors, coefs, mode, y = state
        wsn = ctx.predictor(AffineState(*anchors, *coefs))[-1]
        given.u = after[0][2] - wsn
        (Pi, Vi), (Pf, Vf), y_f = plain_step(given, state, rb)
        shares = step_share(ro, fa, rb, Pi, Vi, Pk, Vk, Pf, Vf)
        require(after[1] == (y_f is not None),
                f"{label}, step {s}: the kernel's contact mode "
                f"{after[1]} differs from the plain step's")
        if y_f is not None:
            zr = torch.zeros_like(y_f[2])
            for key, i in (("buPy", 2), ("buVy", 3)):
                shares[key] = (max_abs(after[2][i], y_f[i]),
                               max_abs(y_f[i], y[i] if mode else zr))
        hold_step(f"{label}, step {s}, against the plain step given the "
                  "kernel's u", shares)
        return max(d / sz if sz > 0 else 0.0 for d, sz in shares.values())

    def witness(s, state, P64, V64, rb):
        """{"P": d, "V": d}: the farthest from (P64, V64) of the float64
        plain steps from ``state`` with its coefficients and y state moved
        at random by one float32 unit, WITNESS_DRAWS draws in one batched
        step."""
        gen = torch.Generator(device=P.device).manual_seed(s)
        draws = WITNESS_DRAWS

        def many(x):
            return x.double().expand(draws, *x.shape)

        def nudge(x):
            x = many(x)
            return x * (1.0 + F32_EPS * torch.randn(
                x.shape, generator=gen, device=x.device, dtype=x.dtype))

        anchors, coefs, mode, y = state
        _, (Pq, Vq), _ = plain_step(ctx64, (
            tuple(many(b) for b in anchors), tuple(nudge(c) for c in coefs),
            mode, None if y is None else tuple(nudge(t) for t in y)),
            rb.double())
        return {"P": max_abs(Pq, P64), "V": max_abs(Vq, V64)}

    e0, e1, _ = basis(P.dtype, P.device)
    zw = torch.zeros((3, ao.fused.r), dtype=P.dtype, device=P.device)
    unit = ((e0, e1, zw, zw), False, None)
    state, prev = ((P, V), *unit), (P, V)
    diff = {"P": 0.0, "V": 0.0}
    share = {"P": (0.0, 0), "V": (0.0, 0)}
    apart, branches = {}, []
    given_worst = (0.0, 0)
    for s in range(1, steps + 1):
        if contact and _rebase_due(s - 1, every):
            state = (prev, *unit)
        Pk, Vk, after, flags = run_k(s)
        rb_s = rb_at(rb_extra, s - 1)
        (Pi, Vi), (Pp, Vp), _ = plain_step(ctx, state, rb_s)
        shares = step_share(ro, fa, rb_s, Pi, Vi, Pk, Vk, Pp, Vp)
        if contact:
            given_worst = max(given_worst, (given_u(s, state, after, Pk, Vk,
                                                    rb_s), s))
        if all(d <= STEP_TOL * sz for d, sz in shares.values()):
            for key, (d, sz) in shares.items():
                diff[key] = max(diff[key], d)
                share[key] = max(share[key], (d / sz if sz > 0 else 0.0, s))
        else:
            _, (P64, V64), _ = plain_step(ctx64, state, rb_s.double())
            seen = witness(s, state, P64, V64, rb_s) if contact else None
            near = {}
            for key, got, pl, ref in (("P", Pk, Pp, P64), ("V", Vk, Vp, V64)):
                e_k, e_p = max_abs(got, ref), max_abs(pl, ref)
                floor = F32_EPS * float(ref.abs().max())
                require(contact or e_k <= ACC_RATIO * max(e_p, floor),
                        f"{label}, step {s} {key}: differs from the plain "
                        f"version by {shares[key][0]:.3e} (step size "
                        f"{shares[key][1]:.3e}) and is {e_k:.3e} from the "
                        f"float64 step, the plain version {e_p:.3e}")
                near[key] = (shares[key][0] / shares[key][1],
                             max(e_k, floor), max(e_p, floor),
                             seen[key] if seen else None)
            branches.append((s, near))
        if s in (1, 2, 3, 4, steps):
            out = plain(ao, P, V, F_, rb_extra, s, iterations)
            done = out[2] if len(out) > 2 else s
            require(done == s, f"{label}: the plain version stopped after "
                    f"{done} of {s} steps")
            apart[s] = (max_abs(Pk, out[0]), max_abs(Vk, out[1]))
        # the kernel's state after s steps is over the anchors of step s
        state, prev = (state[0], *after), (Pk, Vk)
    torch.cuda.synchronize()
    window = ""
    if contact and branches:
        parts = []
        for key in ("P", "V"):
            e_k, e_p, w = zip(*(near[key][1:] for _, near in branches))
            med = (statistics.median(e_k), statistics.median(e_p))
            top = (max(e_k), max(e_p))
            require(med[0] <= ACC_RATIO * med[1]
                    and top[0] <= ACC_RATIO * top[1],
                    f"{label}, {key}: over {len(branches)} branch steps the "
                    f"kernel lies {med[0]:.3e} (median), {top[0]:.3e} (at "
                    f"most) from the float64 step, the plain version "
                    f"{med[1]:.3e}, {top[1]:.3e}")

            def beyond(a, b):
                return sum(x > ACC_RATIO * y for x, y in zip(a, b))

            parts.append(
                f"{key} median {med[0]:.3e} / {med[1]:.3e}, at most "
                f"{top[0]:.3e} / {top[1]:.3e}; beyond {ACC_RATIO}x of the "
                f"other on {beyond(e_k, e_p)} / {beyond(e_p, e_k)} steps, of "
                f"the witness on {beyond(e_k, w)} / {beyond(e_p, w)}")
        window = (f"; over the branch steps, the kernel / the plain version "
                  f"from the float64 step (limit {ACC_RATIO}x): "
                  + "; ".join(parts))
    log(f"[3] {label}: calls of 1..{steps} steps, each step against a plain "
        f"step from the kernel's state: " + "; ".join(
            f"{key} max abs {diff[key]:.3e}, at most {share[key][0]:.3e} of "
            f"the step's size (tol {STEP_TOL}, at step {share[key][1]})"
            for key in ("P", "V"))
        + f" on {steps - len(branches)} of {steps} steps"
        + (f"; every step against the plain step given the kernel's u, the "
           f"y state included: at most {given_worst[0]:.3e} of the step's "
           f"size (tol {STEP_TOL}, at step {given_worst[1]})"
           if contact else "")
        + "; branch steps (share of the step's size, the kernel's and the "
        "plain version's distance from the float64 step"
        + (", the farthest float64 step from inputs one float32 unit away"
           if contact else f"; limit {ACC_RATIO}x") + "): " + (", ".join(
            f"step {s}: " + " ".join(
                f"{key} {x:.3e} {e_k:.3e} {e_p:.3e}"
                + ("" if w is None else f" witness {w:.3e}")
                for key, (x, e_k, e_p, w) in near.items())
            for s, near in branches) or "none")
        + window
        + "; the call of s steps against the plain version's call of s "
        "steps (not held): " + ", ".join(
            f"s={s}: P {p:.3e} V {v:.3e}" for s, (p, v) in apart.items()))
    return max(diff.values()), flags
