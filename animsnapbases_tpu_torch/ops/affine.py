"""Kernels 3 and 4: the affine-coordinate resident loops.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``_make_affine_ctx`` (the shared affine expressions), ``build_resident_affine``
with ``contact_mode=False`` (kernel 3, the lean build: the contact tier of
``run_steps``) and ``build_resident_affine_exit`` (kernel 4: tier 1 when
``resident_chunked_tier1`` is False), ``nb=1``, static targets.

Between anchors the state is carried in affine coordinates: positions and
velocities are (3, 3) base coefficients over the anchors ``b0``, ``b1`` and
the force term ``fa``, plus (3, r) reduced coordinates over the lift U.  A
contact-free step then needs only r-sized products: ``U^T A_c`` of the
anchors (``bu0``, ``bu1``, ``bu_fa``) and ``M_utac = (U^T A_c) U`` take the
place of the (3, r, N) projection, and the selected vertices come from
``U_selT``.  Only the floor test reads O(N) values each step (the y row of
the predictor).  Every ``rebase_every`` steps the state is materialized and
becomes the new anchors.

* ``AffineOperands`` / ``affine_operands``: the resident operands plus
  ``M_utac``, ``U_selT`` and the bound constant ``umax`` (kernel 5).
* ``AffineContext``: the plain transcription of ``_make_affine_ctx``
  (``project_base``, ``materialize``, ``init_anchors``, ``predictor``,
  ``y_predictor``, ``rebase``, ``free_step`` and ``gathered_step``, which
  kernel 5's plain chunk shares), and the lean build's re-anchoring
  contact tail.
* ``resident_affine_plain`` / ``resident_affine`` (kernel 3) and
  ``resident_affine_exit_plain`` / ``resident_affine_exit`` (kernel 4):
  plain versions and the wrappers.  For CUDA tensors a wrapper launches
  ``csrc/affine.cu`` (one C loop enqueues every step's launches) and counts
  the call in its ``launches``; for CPU tensors it runs the plain version;
  it never falls back from the card to the plain version.
* ``resident_affine_batched``: kernel 3's batched build (``nb = B`` in the
  JAX package), the default route of ``make_batched_run``: B independent
  sims in sim-major (B, 3, N) layout in one call, the contact branch per
  sim (a clamping sim takes the contact tail, the others the free step;
  the JAX kernel takes the tail for the whole batch when any sim clamps,
  which the clamp's being the identity for airborne sims makes exact too).
  Its plain version is ``resident_affine_plain`` on (B, 3, N) tensors.

As in kernel 2, ``U^T A_c`` products (the anchors' ``bu0``/``bu1``/``bu_fa``
and the contact tail's projection) accumulate in float64, in the kernel and
the plain version alike (the JAX package sums them in its working dtype;
ROADMAP Queue C), and values are rounded to the storage dtype of the
(3, r, N) matrices before they meet them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.fused_reduced import (
    FusedOperands,
    iterate_plain,
    rowvec_bmm,
    solve_plain,
)
from animsnapbases_tpu_torch.ops.resident import (
    ResidentOperands,
    check_state,
    force_term,
    lift_coords,
    project,
    storage_round,
)

# floor level of a model with the floor off: no predictor ever falls below
# it, so the tier-1 kernels never exit (sim/reduced.py:701-702)
NO_FLOOR = -3.0e38
CONTACT_MODE_TODO = ("the contact_mode=True build of the affine kernel is "
                     "not ported yet (ROADMAP Queue B item 1)")


@dataclass(frozen=True)
class AffineOperands:
    """Everything an affine run needs besides the state."""
    res: ResidentOperands
    M_utac: torch.Tensor     # (3, r, r) working dtype, (U^T A_c) U per dim
    U_selT: torch.Tensor     # (3, r, n_sel) working dtype
    umax: float              # largest y-column norm of the stored lift

    @property
    def fused(self) -> FusedOperands:
        return self.res.fused

    @property
    def floor_level(self) -> float:
        return self.res.floor_h if self.res.floor else NO_FLOOR


def affine_operands(res: ResidentOperands, M_utac, U_selT) -> AffineOperands:
    """Cast the host (numpy, float64) ``M_utac`` and ``U_selT`` once to the
    resident operands' device and working dtype.  ``umax`` is the largest
    column norm of the stored lift's y slice, in float32 as the JAX package
    takes it (the Cauchy-Schwarz constant of kernel 5's floor bound)."""
    device, dtype = res.fused.C_allT.device, res.fused.C_allT.dtype

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64),
                               device=device).to(dtype)

    umax = float(torch.linalg.vector_norm(res.U_liftT[1].float(),
                                          dim=0).max())
    return AffineOperands(res=res, M_utac=t(M_utac), U_selT=t(U_selT),
                          umax=umax)


def basis(dtype, device):
    """The base-coefficient selectors e0, e1, e2: (3, 3), every row the
    unit vector of one of [b0, b1, fa]."""
    eye = torch.eye(3, dtype=dtype, device=device)
    return [eye[j].expand(3, 3).clone() for j in range(3)]


@dataclass
class AffineState:
    """The coefficient state of one run; ``bu0``/``bu1`` are None while the
    anchors' projections are stale."""
    b0: torch.Tensor         # (3, N) anchors
    b1: torch.Tensor
    ap: torch.Tensor         # (3, 3) base coefficients of P and V
    av: torch.Tensor
    wp: torch.Tensor         # (3, r) reduced coordinates of P and V
    wv: torch.Tensor
    bu0: torch.Tensor | None = None
    bu1: torch.Tensor | None = None


class AffineContext:
    """The plain transcription of ``_make_affine_ctx``: the expressions the
    affine kernels (3, 4 and the chunk of 5) share, over the force term
    ``fa = force_term(ro, fext)`` (3, N) of one call and its projection
    ``bu_fa`` (projected here when not given)."""

    def __init__(self, ao: AffineOperands, fa, bu_fa=None):
        ro = ao.res
        self.ao, self.ro, self.fo = ao, ro, ao.fused
        self.fa = fa                              # constant per call
        self.bu_fa = project(ro, fa) if bu_fa is None else bu_fa
        self.e0, self.e1, self.e2 = basis(fa.dtype, fa.device)
        self.gidx = self.fo.gidx.long()

    def damp(self, v):
        return v if self.ro.eta == 1.0 else self.ro.eta * v

    def materialize(self, st: AffineState, a, w):
        """(..., 3, N) state from base coefficients a and reduced coords
        w."""
        return (a[..., 0:1] * st.b0 + a[..., 1:2] * st.b1
                + a[..., 2:3] * self.fa + lift_coords(self.ro, w))

    def init_anchors(self, P, V) -> AffineState:
        zw = P.new_zeros(P.shape[:-1] + (self.fo.r,))
        return AffineState(b0=P, b1=V, ap=self.e0, av=self.e1, wp=zw,
                           wv=zw)

    def refresh_bu(self, st: AffineState):
        if st.bu0 is None:
            st.bu0 = project(self.ro, st.b0)
            st.bu1 = project(self.ro, st.b1)

    def predictor(self, st: AffineState):
        """The damped predictor in affine coordinates -> (ap, av, wp, wv,
        avd, asn, wsn)."""
        avd = self.damp(st.av)
        asn = st.ap + self.ro.dt * avd + self.e2
        wsn = st.wp + self.ro.dt * self.damp(st.wv)
        return st.ap, st.av, st.wp, st.wv, avd, asn, wsn

    def y_predictor(self, st: AffineState, asn, wsn):
        """Only the y row of the predictor (..., N): the exact floor
        test."""
        y = self.ro.U_liftT[1].to(wsn.dtype)
        wy = storage_round(wsn[..., 1, :], self.ro.U_liftT.dtype)
        a = asn[..., 1, :]
        return (a[..., 0:1] * st.b0[..., 1, :] + a[..., 1:2] * st.b1[..., 1, :]
                + a[..., 2:3] * self.fa[..., 1, :] + wy @ y)

    def reset(self, st: AffineState, b0, b1):
        """New anchors, unit coefficients, stale projections."""
        zw = torch.zeros_like(st.wp)
        st.b0, st.b1 = b0, b1
        st.ap, st.av, st.wp, st.wv = self.e0, self.e1, zw, zw
        st.bu0 = st.bu1 = None

    def rebase(self, st: AffineState):
        """Re-anchor at the current materialized state."""
        self.reset(st, self.materialize(st, st.ap, st.wp),
                   self.materialize(st, st.av, st.wv))

    def free_step(self, st: AffineState, asn, wsn, avd, wp, rb_ex,
                  num_iterations):
        """One contact-free step entirely in affine coordinates, the
        gathered values of the predictor taken through ``U_selT``."""
        n_sel = self.ro.n_sel
        snT_sel = (asn[..., 0:1] * st.b0[..., :n_sel]
                   + asn[..., 1:2] * st.b1[..., :n_sel]
                   + asn[..., 2:3] * self.fa[..., :n_sel]
                   + rowvec_bmm(wsn, self.ao.U_selT))
        self.gathered_step(st, asn, wsn, avd, wp, snT_sel[..., self.gidx],
                           rb_ex, num_iterations)

    def gathered_step(self, st: AffineState, asn, wsn, avd, wp, Vc, rb_ex,
                      num_iterations):
        """The contact-free step from the predictor's gathered values ``Vc``
        (3, g_total).  The coefficient updates avoid the cancelling
        subtraction: ``(aq - ap)/dt == eta av + e2/dt`` exactly."""
        fo = self.fo
        self.refresh_bu(st)
        rb_lin = (asn[..., 0:1] * st.bu0 + asn[..., 1:2] * st.bu1
                  + asn[..., 2:3] * self.bu_fa
                  + rowvec_bmm(wsn, self.ao.M_utac))
        rb = iterate_plain(fo, Vc, rb_ex - rb_lin, num_iterations)
        wq = wsn + solve_plain(fo, rb)
        st.ap = asn
        st.av = avd + self.e2 / self.ro.dt
        st.wp = wq
        st.wv = (wq - wp) / self.ro.dt

    def contact_reanchor(self, st: AffineState, ap, wp, asn, wsn, rb_ex,
                         num_iterations):
        """The lean build's contact tail (pallas_resident.py:890-912): the
        exact standard step on the materialized state, whose result
        becomes the new anchors."""
        ro, fo = self.ro, self.fo
        P = self.materialize(st, ap, wp)
        sn = self.materialize(st, asn, wsn)
        y = sn[..., 1, :]
        sn[..., 1, :] = torch.where(y < ro.floor_h,
                                    torch.full_like(y, ro.floor_h), y)
        rb = iterate_plain(fo, sn[..., :ro.n_sel][..., self.gidx],
                           rb_ex - project(ro, sn), num_iterations)
        q = sn + lift_coords(ro, solve_plain(fo, rb))
        self.reset(st, q, (q - P) / ro.dt)

    def output(self, st: AffineState):
        """The final materialization -> (P', V')."""
        return (self.materialize(st, st.ap, st.wp),
                self.materialize(st, st.av, st.wv))


def _rebase_due(i: int, rebase_every: int) -> bool:
    return i > 0 and i % rebase_every == 0


def _merge(mask, x, y):
    """x where the sim's ``mask`` (B,) is set, else y: per-sim (·, ·)
    values, each of x and y batched (B, ·, ·) or shared by the sims."""
    return torch.where(mask[:, None, None], x, y)


def resident_affine_plain(ao: AffineOperands, P, V, fext, rb_extra,
                          num_steps: int, num_iterations: int,
                          rebase_every: int = 256,
                          contact_mode: bool = False):
    """Plain version of kernel 3, the lean build: ``num_steps`` steps ->
    (P', V').  Each step tests the exact y row of the predictor against the
    floor; a clamped step runs the re-anchoring contact tail.  With a
    leading batch axis (B, 3, N) of independent sims (``rb_extra`` (3, r)
    shared) it is the plain version of the batched build, whose branch is
    per sim: the sims that clamp take the contact tail, the others the free
    step."""
    if contact_mode:
        raise NotImplementedError(CONTACT_MODE_TODO)
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    ro = ao.res
    ctx = AffineContext(ao, force_term(ro, fext))
    st = ctx.init_anchors(P, V)
    for i in range(num_steps):
        if _rebase_due(i, rebase_every):
            ctx.rebase(st)
        ap, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        clamped = (ctx.y_predictor(st, asn, wsn) < ro.floor_h).any(-1) \
            if ro.floor else torch.zeros(P.shape[:-2], dtype=torch.bool)
        if not bool(clamped.any()):
            ctx.free_step(st, asn, wsn, avd, wp, rb_extra, num_iterations)
        elif bool(clamped.all()):
            ctx.contact_reanchor(st, ap, wp, asn, wsn, rb_extra,
                                 num_iterations)
        else:
            # some sims of a batch clamp: both branches from the same
            # state, each sim keeping its own
            free = dataclasses.replace(st)
            ctx.free_step(free, asn, wsn, avd, wp, rb_extra, num_iterations)
            ctx.contact_reanchor(st, ap, wp, asn, wsn, rb_extra,
                                 num_iterations)
            for f in ("b0", "b1", "ap", "av", "wp", "wv"):
                setattr(st, f, _merge(clamped, getattr(st, f),
                                      getattr(free, f)))
            st.bu0 = st.bu1 = None
    return ctx.output(st)


def resident_affine_exit_plain(ao: AffineOperands, P, V, fext, rb_extra,
                               num_steps: int, num_iterations: int,
                               rebase_every: int = 256):
    """Plain version of kernel 4: contact-free steps until the first step
    whose predictor the floor would clamp, which is not applied ->
    (P', V', steps_done)."""
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx = AffineContext(ao, force_term(ao.res, fext))
    st = ctx.init_anchors(P, V)
    floor_h = ao.floor_level
    done = 0
    for i in range(num_steps):
        if _rebase_due(i, rebase_every):
            ctx.rebase(st)
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        if bool((ctx.y_predictor(st, asn, wsn) < floor_h).any()):
            break
        ctx.free_step(st, asn, wsn, avd, wp, rb_extra, num_iterations)
        done += 1
    P_out, V_out = ctx.output(st)
    return P_out, V_out, done


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

_SYMBOLS = {
    (torch.float32, torch.float32): "resident_affine_f32_f32",
    (torch.float32, torch.bfloat16): "resident_affine_f32_bf16",
}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = (_P,) * 22 + (_I,) * 11 + (_D,) * 3 + (_P,)
# int32 flag slots of one sim of a call (csrc/affine.cu): stale, done,
# steps done, then one "clamped" slot per step
FLAG_SLOTS = 3


def split_coef(coef, r: int):
    """(ap, av, wp, wv) as views of a flat coefficient buffer of
    2 * 9 + 2 * 3 * r values (or (B, ·) of them, one row per sim), the
    layout of csrc/affine.cu and csrc/affine_chunked.cu."""
    lead = coef.shape[:-1]
    return (coef[..., 0:9].view(*lead, 3, 3),
            coef[..., 9:18].view(*lead, 3, 3),
            coef[..., 18:18 + 3 * r].view(*lead, 3, r),
            coef[..., 18 + 3 * r:].view(*lead, 3, r))


def _launch_affine(ao: AffineOperands, P, V, fext, rb_extra,
                   num_steps: int, num_iterations: int, rebase_every: int,
                   exit_variant: bool):
    """Enqueue one call of csrc/affine.cu on the (3, N) state, or the
    (B, 3, N) states of B sims -> (P', V', flags, coef): coef holds the
    coefficients (:func:`split_coef`) over the last anchors, which are the
    inputs P, V when no rebase fell in the call; flags and coef have a
    leading sim axis when the state has."""
    ro, fo = ao.res, ao.fused
    check_state(ro, P, V, fext, rb_extra)
    if rebase_every < 1:
        raise ValueError("rebase_every must be >= 1")
    batched = P.dim() == 3
    nb = P.shape[0] if batched else 1
    if exit_variant and batched:
        raise ValueError("kernel 4 has no batched build")
    fn = _build.function("affine", _SYMBOLS[(P.dtype, ro.U_liftT.dtype)],
                         _ARGTYPES)
    dev = P.device
    n, r = ro.n, fo.r
    tile = affine_tile()
    nblk = (n + tile - 1) // tile
    b0 = P.contiguous().clone()          # the anchors, then the outputs
    b1 = V.contiguous().clone()
    fa = force_term(ro, fext).contiguous()
    rb_extra = rb_extra.contiguous()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    coef = f32(nb, 2 * 9 + 2 * 3 * r)    # ap, av, wp, wv
    bu = f32(nb, 3 * 3 * r)              # bu0, bu1, bu_fa
    sn, Pm = torch.empty_like(b0), torch.empty_like(b0)
    u = f32(nb, 3 * r)
    # float64 per-tile partials of U^T A_c: two (3, r) sums per tile
    partial = torch.empty((nb, nblk, 2, 3 * r), dtype=torch.float64,
                          device=dev)
    stride = FLAG_SLOTS + max(num_steps, 1)
    flags = torch.zeros((nb, stride), dtype=torch.int32, device=dev)
    p = _build.ptr
    code = fn(p(b0), p(b1), p(fa), p(rb_extra), p(ro.U_liftT), p(ro.ut_acT),
              p(ao.M_utac), p(ao.U_selT), p(fo.C_allT), p(fo.inv3),
              p(fo.WT_all), p(fo.gidx), p(fo.elem_kind), p(fo.elem_g),
              p(fo.elem_f), p(coef), p(bu), p(sn), p(Pm), p(u), p(partial),
              p(flags), n, r, ro.n_sel, fo.g_total, fo.m_total, int(num_steps),
              int(num_iterations), int(rebase_every),
              (1 if exit_variant else (2 if ro.floor else 0)), nb, stride,
              ro.dt, ro.eta, ao.floor_level, _build.stream_of(dev))
    _build.check("affine", code, "resident_affine")
    if not batched:
        flags, coef = flags[0], coef[0]
    return b0, b1, flags, coef


def resident_affine(ao: AffineOperands, P, V, fext, rb_extra,
                    num_steps: int, num_iterations: int,
                    rebase_every: int = 256, contact_mode: bool = False):
    """Kernel 3, the lean build: (P', V') after ``num_steps`` steps from the
    permuted (3, N) state.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/affine.cu`` on the current stream, or raise.  The inputs
    are not modified."""
    if contact_mode:
        raise NotImplementedError(CONTACT_MODE_TODO)
    if P.device.type == "cpu":
        return resident_affine_plain(ao, P, V, fext, rb_extra, num_steps,
                                     num_iterations, rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if P.dim() != 2:
        raise ValueError("P must be (3, N): a batch of sims takes "
                         "resident_affine_batched")
    P_out, V_out = _launch_affine(ao, P, V, fext, rb_extra, num_steps,
                                  num_iterations, rebase_every, False)[:2]
    resident_affine.launches += 1
    return P_out, V_out


resident_affine.launches = 0


def resident_affine_batched(ao: AffineOperands, P, V, fext, rb_extra,
                            num_steps: int, num_iterations: int,
                            rebase_every: int = 256,
                            contact_mode: bool = False):
    """The batched build of kernel 3 (lean): (P', V') (B, 3, N) of B
    independent sims after ``num_steps`` steps from their permuted
    (B, 3, N) states and forces, the static target term ``rb_extra``
    (3, r) shared.  The contact branch is per sim.  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/affine.cu`` with B sims, or
    raise.  The inputs are not modified."""
    if contact_mode:
        raise NotImplementedError(CONTACT_MODE_TODO)
    if P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return resident_affine_plain(ao, P, V, fext, rb_extra, num_steps,
                                     num_iterations, rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    P_out, V_out = _launch_affine(ao, P, V, fext, rb_extra, num_steps,
                                  num_iterations, rebase_every, False)[:2]
    resident_affine_batched.launches += 1
    return P_out, V_out


resident_affine_batched.launches = 0


def resident_affine_exit(ao: AffineOperands, P, V, fext, rb_extra,
                         num_steps: int, num_iterations: int,
                         rebase_every: int = 256):
    """Kernel 4: (P', V', steps_done) from the permuted (3, N) state; the
    run stops before the first step the floor would clamp.  CPU tensors
    run the plain version; CUDA tensors launch the exit variant of
    ``csrc/affine.cu`` and read ``steps_done`` back (one 4-byte copy), or
    raise.  The inputs are not modified."""
    if P.device.type == "cpu":
        return resident_affine_exit_plain(ao, P, V, fext, rb_extra,
                                          num_steps, num_iterations,
                                          rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if P.dim() != 2:
        raise ValueError("P must be (3, N): kernel 4 has no batched build")
    P_out, V_out, flags, _ = _launch_affine(ao, P, V, fext, rb_extra,
                                            num_steps, num_iterations,
                                            rebase_every, True)
    resident_affine_exit.launches += 1
    return P_out, V_out, int(flags[2])


resident_affine_exit.launches = 0


def affine_tile() -> int:
    """Vertices per block of the O(N) launches of csrc/affine.cu."""
    return int(_build.function("affine", "affine_tile", ())())
