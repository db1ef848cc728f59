"""Kernels 3 and 4: the affine-coordinate resident loops.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``_make_affine_ctx`` (the shared affine expressions), ``build_resident_affine``
(kernel 3: the contact tier of ``run_steps``) in its two builds, the lean one
(``contact_mode=False``) and the contact-mode one (``contact_mode=True``),
and ``build_resident_affine_exit`` (kernel 4: tier 1 when
``resident_chunked_tier1`` is False).  Step i of a call reads row
min(i, T - 1) of the target-term schedule ``rb_extra`` (``ops/resident.py``
:func:`rb_at`), in its free step, the lean contact tail and a contact-mode
step alike.

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
  ``M_utac``, ``U_selT`` and the floor bounds' constants ``umax`` and
  ``y_range`` (kernel 5).
* ``AffineContext``: the plain transcription of ``_make_affine_ctx``
  (``project_base``, ``materialize``, ``init_anchors``, ``predictor``,
  ``y_predictor``, ``rebase``, ``free_step`` and ``gathered_step``, which
  kernel 5's plain chunk shares), the lean build's re-anchoring contact
  tail, and the contact-mode build's pieces (``enter_contact``,
  ``contact_step``, the mixed rebase and output); ``step`` is one step of
  kernel 3's loop in either build.
* ``affine_run_plain`` / ``resident_affine_plain`` (kernel 3, either build;
  ``resident_affine_contact_plain`` names the contact-mode one) and
  ``resident_affine_exit_plain`` (kernel 4, solo and batched): the plain
  versions.
* The wrappers ``resident_affine`` (kernel 3, lean), ``resident_affine_contact``
  (kernel 3, contact mode) and ``resident_affine_exit`` (kernel 4).  For CUDA
  tensors a wrapper launches ``csrc/affine.cu`` (one C loop enqueues every
  step's launches; the step's loop runs on one cluster of three blocks per
  sim, on the staging plan of :func:`affine_plan`) and counts the call in
  its ``launches``; for CPU tensors it runs the plain version; it never
  falls back from the card to the plain version.
* ``resident_affine_batched`` and ``resident_affine_contact_batched``: kernel
  3's batched builds (``nb = B`` in the JAX package), the routes of
  ``make_batched_run`` below ``CHUNKED_TIER1_MIN_VERTS``: B independent sims
  in sim-major (B, 3, N) layout in one call, each with its own launch
  counter.  Their plain version is ``resident_affine_plain`` on (B, 3, N)
  tensors.  The contact branch is per sim: in the lean build a clamping sim
  takes the contact tail and the others the free step; in the contact-mode
  build each sim has its own mode, entered when its own predictor clamps.
  The JAX kernel keeps one branch (lean) or one mode flag (contact mode) for
  the whole batch and sends every sim through the exact contact path when
  any sim clamps; the clamp is the identity for airborne sims, so both are
  exact (ROADMAP Queue C), and per sim keeps sim b of a batched call equal
  to its solo call.
* ``resident_affine_exit_batched``: kernel 4's batched build, with the JAX
  kernel's whole-batch exit (every sim commits to the steps before the
  first that any sim would clamp) and its own launch counter.  No entry
  point takes it: the JAX package builds kernel 4 solo only
  (``sim/reduced.py:800-803``), and ``make_batched_run`` serves a batch on
  kernels 3 and 5.

Contact mode (``pallas_resident.py:732-870``, ``:928-936``): a sim whose
predictor clamps enters it.  Its x and z rows stay in affine coordinates;
its y row is carried materialized (``Py``, ``Vy``, (..., N)) with its
projections ``buPy``, ``buVy`` (..., r) kept by the recursion
``buPy' = buPy + dt eta buVy + bu_fa_y + pc + u_y M_utac_y``, where ``pc``
projects the clamp's correction of the y predictor.  A contact step then
reads two (r, N) slices (``pc`` and the lift of ``u_y``) in place of the
lean tail's full predictor, projection and lift.  The mode is left at the
next rebase, whose materialization takes the y row from ``Py``/``Vy``.  As in
the JAX kernel, ``corr_y`` and ``u_y`` are rounded to the storage dtype
before they meet the (r, N) slices, the entry lift rounds ``wp_y``/``wv_y``
as every lift does, and the ``buPy``/``buVy`` recursions stay in the working
dtype; ``pc`` accumulates in float64 like the other ``U^T A_c`` products.

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
from animsnapbases_tpu_torch.ops.cluster import launch_plan
from animsnapbases_tpu_torch.ops.fused_reduced import (
    FusedOperands,
    gather_vc,
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
    rb_at,
    rb_layout,
    storage_round,
)
from animsnapbases_tpu_torch.utils.profiling import (
    count,
    count_bytes,
    device_counts_ptr,
    register_launches,
)

# floor level of a model with the floor off: no predictor ever falls below
# it, so the tier-1 kernels never exit (sim/reduced.py:701-702)
NO_FLOOR = -3.0e38


@dataclass(frozen=True)
class AffineOperands:
    """Everything an affine run needs besides the state."""
    res: ResidentOperands
    M_utac: torch.Tensor     # (3, r, r) working dtype, (U^T A_c) U per dim
    U_selT: torch.Tensor     # (3, r, n_sel) working dtype
    umax: float              # largest y-column norm of the stored lift
    y_range: torch.Tensor    # (2, r) working dtype: each y row's min, max

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
    takes it (the Cauchy-Schwarz constant of kernel 5's floor bound).
    ``y_range`` holds the minimum (row 0) and the maximum (row 1) over all
    N vertices, pinned included, of each row of that slice, in the storage
    dtype widened to the working dtype as the exact y row widens it (the
    constants of kernel 5's per-mode interval bound)."""
    device, dtype = res.fused.C_allT.device, res.fused.C_allT.dtype

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64),
                               device=device).to(dtype)

    uy = res.U_liftT[1]
    umax = float(torch.linalg.vector_norm(uy.float(), dim=0).max())
    y_range = torch.stack(torch.aminmax(uy.to(dtype), dim=1)).contiguous()
    return AffineOperands(res=res, M_utac=t(M_utac), U_selT=t(U_selT),
                          umax=umax, y_range=y_range)


def basis(dtype, device):
    """The base-coefficient selectors e0, e1, e2: (3, 3), every row the
    unit vector of one of [b0, b1, fa]."""
    eye = torch.eye(3, dtype=dtype, device=device)
    return [eye[j].expand(3, 3).clone() for j in range(3)]


@dataclass
class AffineState:
    """The coefficient state of one run; ``bu0``/``bu1`` are None while the
    anchors' projections are stale.  In the contact-mode build ``mode``
    (per sim, bool) says which sims carry their y row materialized in
    ``Py``, ``Vy`` (..., N) with projections ``buPy``, ``buVy`` (..., r); it
    is None in the other builds."""
    b0: torch.Tensor         # (3, N) anchors
    b1: torch.Tensor
    ap: torch.Tensor         # (3, 3) base coefficients of P and V
    av: torch.Tensor
    wp: torch.Tensor         # (3, r) reduced coordinates of P and V
    wv: torch.Tensor
    bu0: torch.Tensor | None = None
    bu1: torch.Tensor | None = None
    mode: torch.Tensor | None = None
    Py: torch.Tensor | None = None
    Vy: torch.Tensor | None = None
    buPy: torch.Tensor | None = None
    buVy: torch.Tensor | None = None


_COEFS = ("ap", "av", "wp", "wv")
_Y_STATE = ("Py", "Vy", "buPy", "buVy")


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
        """Only the y row (..., N) of the state with coefficients asn, wsn:
        of the predictor, the exact floor test; of P or V, contact mode's
        entry."""
        y = self.ro.U_liftT[1].to(wsn.dtype)
        wy = storage_round(wsn[..., 1, :], self.ro.U_liftT.dtype)
        a = asn[..., 1, :]
        return (a[..., 0:1] * st.b0[..., 1, :] + a[..., 1:2] * st.b1[..., 1, :]
                + a[..., 2:3] * self.fa[..., 1, :] + wy @ y)

    def project_y(self, y):
        """``U^T A_c`` of y rows (..., N) through the y slice -> (..., r):
        y rounded to the storage dtype, accumulated in float64."""
        ut = self.ro.ut_acT
        ym = storage_round(y, ut.dtype).double()
        return torch.einsum("kn,...n->...k", ut[1].double(), ym).to(y.dtype)

    def reset(self, st: AffineState, b0, b1):
        """New anchors, unit coefficients, stale projections; contact mode
        left."""
        zw = torch.zeros_like(st.wp)
        st.b0, st.b1 = b0, b1
        st.ap, st.av, st.wp, st.wv = self.e0, self.e1, zw, zw
        st.bu0 = st.bu1 = None
        if st.mode is not None:
            st.mode = torch.zeros_like(st.mode)

    def rebase(self, st: AffineState):
        """Re-anchor at the current materialized state (in contact mode the
        mixed one, :meth:`output`), which leaves contact mode."""
        self.reset(st, *self.output(st))

    def rb_lin(self, st: AffineState, asn, wsn):
        """``U^T A_c`` of the predictor (..., 3, r) from the anchors'
        projections and ``M_utac``."""
        self.refresh_bu(st)
        return (asn[..., 0:1] * st.bu0 + asn[..., 1:2] * st.bu1
                + asn[..., 2:3] * self.bu_fa
                + rowvec_bmm(wsn, self.ao.M_utac))

    def selected(self, st: AffineState, asn, wsn):
        """The predictor at the selected prefix (..., 3, n_sel), through
        ``U_selT``."""
        n_sel = self.ro.n_sel
        return (asn[..., 0:1] * st.b0[..., :n_sel]
                + asn[..., 1:2] * st.b1[..., :n_sel]
                + asn[..., 2:3] * self.fa[..., :n_sel]
                + rowvec_bmm(wsn, self.ao.U_selT))

    def free_step(self, st: AffineState, asn, wsn, avd, wp, rb_ex,
                  num_iterations):
        """One contact-free step entirely in affine coordinates, the
        gathered values of the predictor taken through ``U_selT``."""
        self.gathered_step(st, asn, wsn, avd, wp,
                           gather_vc(self.fo, self.selected(st, asn, wsn)),
                           rb_ex, num_iterations)

    def gathered_step(self, st: AffineState, asn, wsn, avd, wp, Vc, rb_ex,
                      num_iterations):
        """The contact-free step from the predictor's gathered values ``Vc``
        (3, g_total)."""
        self.solve_update(st, asn, wsn, avd, wp, Vc,
                          rb_ex - self.rb_lin(st, asn, wsn), num_iterations)

    def solve(self, Vc, rb_const, num_iterations):
        """The iteration loop from the gathered values ``Vc`` and
        ``rb_const``, and its reduced solve -> u (..., 3, r)."""
        fo = self.fo
        return solve_plain(fo, iterate_plain(fo, Vc, rb_const,
                                             num_iterations))

    def solve_update(self, st: AffineState, asn, wsn, avd, wp, Vc, rb_const,
                     num_iterations):
        """The loop from ``Vc`` and ``rb_const``, its solve u, and the
        coefficient update -> u.  The update avoids the cancelling
        subtraction: ``(aq - ap)/dt == eta av + e2/dt`` exactly."""
        u = self.solve(Vc, rb_const, num_iterations)
        wq = wsn + u
        st.ap = asn
        st.av = avd + self.e2 / self.ro.dt
        st.wp = wq
        st.wv = (wq - wp) / self.ro.dt
        return u

    def init_contact(self, st: AffineState):
        """The contact-mode build's per-sim state: mode off, y state 0."""
        lead = st.b0.shape[:-2]
        st.mode = torch.zeros(lead, dtype=torch.bool, device=st.b0.device)
        st.Py = st.Vy = st.b0.new_zeros(lead + (self.ro.n,))
        st.buPy = st.buVy = st.b0.new_zeros(lead + (self.fo.r,))

    def enter_contact(self, st: AffineState, ap, av, wp, wv, enter):
        """Contact mode's entry (pallas_resident.py:831-864) for the sims
        of ``enter``: their y rows of P and V materialized from the
        coefficients, and their projections formed from the anchors'
        (``bu0``, ``bu1``, ``bu_fa``) and ``M_utac``."""
        self.refresh_bu(st)
        M = self.ao.M_utac[1]

        def proj(a, w):
            a = a[..., 1, :]
            return (a[..., 0:1] * st.bu0[..., 1, :]
                    + a[..., 1:2] * st.bu1[..., 1, :]
                    + a[..., 2:3] * self.bu_fa[..., 1, :] + w[..., 1, :] @ M)

        for name, new in zip(_Y_STATE, (
                self.y_predictor(st, ap, wp), self.y_predictor(st, av, wv),
                proj(ap, wp), proj(av, wv))):
            setattr(st, name, _merge(enter, new, getattr(st, name), 1))
        st.mode = st.mode | enter

    def contact_step(self, st: AffineState, asn, wsn, avd, wp, rb_ex,
                     num_iterations):
        """One exact step in contact mode (pallas_resident.py:762-819): x/z
        in affine coordinates, y from ``Py``/``Vy``; its projection from the
        recursions and ``pc``, the projection of the clamp's correction."""
        ro = self.ro
        dt = ro.dt
        sn_y = st.Py + dt * self.damp(st.Vy) + self.fa[..., 1, :]
        sn_cl = torch.clamp(sn_y, min=ro.floor_h)
        pc = self.project_y(sn_cl - sn_y)
        bupsn = st.buPy + dt * self.damp(st.buVy) + self.bu_fa[..., 1, :]
        s = bupsn + pc
        rb_lin = _with_y(self.rb_lin(st, asn, wsn), s)
        Vc = _with_y(self.selected(st, asn, wsn), sn_cl[..., :ro.n_sel])
        u = self.solve_update(st, asn, wsn, avd, wp, gather_vc(self.fo, Vc),
                              rb_ex - rb_lin, num_iterations)
        u_y = u[..., 1, :]
        q_y = sn_cl + (storage_round(u_y, ro.U_liftT.dtype)
                       @ ro.U_liftT[1].to(u_y.dtype))
        st.Vy = (q_y - st.Py) / dt
        st.Py = q_y
        bup = s + u_y @ self.ao.M_utac[1]
        st.buVy = (bup - st.buPy) / dt
        st.buPy = bup

    def step(self, st: AffineState, rb_ex, num_iterations):
        """One step of kernel 3's loop (no rebase), in the lean build or,
        when ``st.mode`` is set, the contact-mode build -> per sim what
        csrc/affine.cu records of the step: 1 when the floor test clamped
        (the lean contact tail, contact mode's entry), plus 2 when it ran
        in contact mode."""
        ro = self.ro
        ap, av, wp, wv, avd, asn, wsn = self.predictor(st)
        lead = st.b0.shape[:-2]
        clamped = ((self.y_predictor(st, asn, wsn) < ro.floor_h).any(-1)
                   if ro.floor else torch.zeros(lead, dtype=torch.bool,
                                                device=st.b0.device))

        def free(s):
            self.free_step(s, asn, wsn, avd, wp, rb_ex, num_iterations)

        if st.mode is None:
            self._branch(st, clamped, free, lambda s: self.contact_reanchor(
                s, ap, wp, asn, wsn, rb_ex, num_iterations),
                _COEFS + ("b0", "b1"))
            return clamped.int()
        clamped = clamped & ~st.mode
        if bool(clamped.any()):
            self.enter_contact(st, ap, av, wp, wv, clamped)
        mode = st.mode
        self._branch(st, mode, free, lambda s: self.contact_step(
            s, asn, wsn, avd, wp, rb_ex, num_iterations), _COEFS + _Y_STATE)
        return clamped.int() + 2 * mode.int()

    @staticmethod
    def _branch(st: AffineState, mask, free, contact, fields):
        """``contact(st)`` for the sims of ``mask``, ``free(st)`` for the
        others: on a batch whose sims part, both from the same state, each
        sim keeping its own ``fields``."""
        if not bool(mask.any()):
            free(st)
        elif bool(mask.all()):
            contact(st)
        else:
            other = dataclasses.replace(st)
            free(other)
            contact(st)
            for f in fields:
                dims = 1 if f in _Y_STATE else 2
                setattr(st, f, _merge(mask, getattr(st, f),
                                      getattr(other, f), dims))
            if "b0" in fields:
                st.bu0 = st.bu1 = None

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
        rb = iterate_plain(fo, gather_vc(fo, sn),
                           rb_ex - project(ro, sn), num_iterations)
        q = sn + lift_coords(ro, solve_plain(fo, rb))
        self.reset(st, q, (q - P) / ro.dt)

    def output(self, st: AffineState):
        """The materialization -> (P', V'); in contact mode the mixed one
        (pallas_resident.py:739-742, :928-936): x/z from the coefficients, y
        from ``Py``/``Vy``."""
        P = self.materialize(st, st.ap, st.wp)
        V = self.materialize(st, st.av, st.wv)
        if st.mode is not None and bool(st.mode.any()):
            P = _with_y(P, _merge(st.mode, st.Py, P[..., 1, :], 1))
            V = _with_y(V, _merge(st.mode, st.Vy, V[..., 1, :], 1))
        return P, V


def _rebase_due(i: int, rebase_every: int) -> bool:
    return i > 0 and i % rebase_every == 0


def _merge(mask, x, y, dims=2):
    """x where the sim's ``mask`` (per sim, bool) is set, else y: per-sim
    values of ``dims`` axes, each of x and y batched or shared by the
    sims."""
    return torch.where(mask.view(mask.shape + (1,) * dims), x, y)


def _with_y(x, y):
    """x (..., 3, ·) with its y row replaced by y (..., ·)."""
    return torch.cat([x[..., 0:1, :], y[..., None, :], x[..., 2:3, :]],
                     dim=-2)


def affine_run_plain(ao: AffineOperands, P, V, fext, rb_extra,
                     num_steps: int, num_iterations: int,
                     rebase_every: int = 256, contact_mode: bool = False):
    """The loop of kernel 3's plain version -> (context, state, flags):
    ``flags`` (..., num_steps) int32 holds what csrc/affine.cu records of
    each step (:meth:`AffineContext.step`); step i takes the target term
    ``rb_at(rb_extra, i)``.  ``contact_mode`` selects the
    contact-mode build; with the floor off it is the lean build, as in the
    JAX kernel.  It counts what the kernel counts (``utils/profiling.py``):
    ``k3.contact_steps``, the sim-steps run in contact mode."""
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    ro = ao.res
    ctx = AffineContext(ao, force_term(ro, fext))
    st = ctx.init_anchors(P, V)
    if contact_mode and ro.floor:
        ctx.init_contact(st)
    flags = torch.zeros(P.shape[:-2] + (num_steps,), dtype=torch.int32,
                        device=P.device)
    for i in range(num_steps):
        if _rebase_due(i, rebase_every):
            ctx.rebase(st)
        flags[..., i] = ctx.step(st, rb_at(rb_extra, i), num_iterations)
    count("k3.contact_steps", int((flags & 2).count_nonzero()))
    return ctx, st, flags


def resident_affine_plain(ao: AffineOperands, P, V, fext, rb_extra,
                          num_steps: int, num_iterations: int,
                          rebase_every: int = 256,
                          contact_mode: bool = False):
    """Plain version of kernel 3: ``num_steps`` steps -> (P', V').  Each
    step tests the exact y row of the predictor against the floor.  In the
    lean build a clamped step runs the re-anchoring contact tail; in the
    contact-mode build (``contact_mode``) it enters contact mode, which
    serves every step until the next rebase.  With a leading batch axis
    (B, 3, N) of independent sims (``rb_extra`` shared or per sim) it is
    the plain version of the batched build, whose branch and mode are per
    sim."""
    ctx, st, _ = affine_run_plain(ao, P, V, fext, rb_extra, num_steps,
                                  num_iterations, rebase_every, contact_mode)
    return ctx.output(st)


def resident_affine_exit_plain(ao: AffineOperands, P, V, fext, rb_extra,
                               num_steps: int, num_iterations: int,
                               rebase_every: int = 256):
    """Plain version of kernel 4: contact-free steps until the first step
    whose predictor the floor would clamp, which is not applied ->
    (P', V', steps_done).  With a leading batch axis (B, 3, N) of
    independent sims (``rb_extra`` shared or per sim) it is the plain
    version of the batched build, with the JAX kernel's whole-batch exit
    (``pallas_resident.py:1075-1089``): the floor test looks at every sim,
    and the batch stops at the first step that any sim would clamp."""
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
        ctx.free_step(st, asn, wsn, avd, wp, rb_at(rb_extra, i),
                      num_iterations)
        done += 1
    P_out, V_out = ctx.output(st)
    return P_out, V_out, done


def resident_affine_contact_plain(ao: AffineOperands, P, V, fext, rb_extra,
                                  num_steps: int, num_iterations: int,
                                  rebase_every: int = 256):
    """Plain version of kernel 3's contact-mode build
    (:func:`resident_affine_plain` with ``contact_mode``)."""
    return resident_affine_plain(ao, P, V, fext, rb_extra, num_steps,
                                 num_iterations, rebase_every,
                                 contact_mode=True)


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
_L = ctypes.c_longlong
_ARGTYPES = (_P,) * 27 + (_I,) * 11 + (_D,) * 3 + (_I, _L, _P) + (_I,) * 3 + (
    _P, _P, _P)
# int32 flag slots of one sim of a call (csrc/affine.cu): stale, done,
# steps done, contact mode, then one slot per step (what
# AffineContext.step returns: 1 the floor test clamped, 2 contact mode)
FLAG_SLOTS = 4
MODE_SLOT = 3
# the kernel's mode of each variant, with the floor on (csrc/affine.cu);
# every variant without the floor runs free steps only (LEAN_NO_FLOOR)
_VARIANTS = {"lean": 2, "exit": 1, "contact": 3}


def split_coef(coef, r: int):
    """(ap, av, wp, wv) as views of a flat coefficient buffer of
    2 * 9 + 2 * 3 * r values (or (B, ·) of them, one row per sim), the
    layout of csrc/affine.cu and csrc/affine_chunked.cu."""
    lead = coef.shape[:-1]
    return (coef[..., 0:9].view(*lead, 3, 3),
            coef[..., 9:18].view(*lead, 3, 3),
            coef[..., 18:18 + 3 * r].view(*lead, 3, r),
            coef[..., 18 + 3 * r:].view(*lead, 3, r))


def affine_plan(ao: AffineOperands, nb: int = 1, clusters=None):
    """The staging plan (ops/cluster.py) the cluster launches of
    csrc/affine.cu run on for nb sims (:func:`~animsnapbases_tpu_torch.ops.
    cluster.launch_plan`: the full plan for one sim; for a batch, the plan
    that needs the fewest waves of clusters on the card)."""
    fo = ao.fused
    return launch_plan("affine", "affine", nb, fo.r, fo.g_total, fo.m_total,
                       ao.res.n_sel, clusters=clusters)


def affine_buffers(ao: AffineOperands, P, V, fext, num_steps: int,
                   variant: str, tile: int) -> dict:
    """The buffers of one call of csrc/affine.cu on the (3, N) state or the
    (B, 3, N) states of B sims, in the entry point's order from ``b0`` to
    ``flags`` (``tile``: vertices a block of its O(N) launches)."""
    ro, r, n = ao.res, ao.fused.r, ao.res.n
    nb = P.shape[0] if P.dim() == 3 else 1
    nblk = (n + tile - 1) // tile
    dev = P.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    b0 = P.contiguous().clone()          # the anchors, then the outputs
    # contact mode's per-sim y state: Py, Vy and buPy, buVy, 0 until a sim
    # enters the mode (as in the plain version)
    ny = nb if variant == "contact" and ro.floor else 0
    return {
        "b0": b0, "b1": V.contiguous().clone(),
        "fa": force_term(ro, fext).contiguous(),
        "coef": f32(nb, 2 * 9 + 2 * 3 * r),    # ap, av, wp, wv
        "bu": f32(nb, 3 * 3 * r),              # bu0, bu1, bu_fa
        "sn": torch.empty_like(b0), "Pm": torch.empty_like(b0),
        "u": f32(nb, 3 * r),
        # float64 per-tile partials of U^T A_c: two (3, r) sums per tile,
        # and in contact mode one (r,) sum of the y slice per tile (pc)
        "partial": torch.empty((nb, nblk, 2, 3 * r), dtype=torch.float64,
                               device=dev),
        "ys": torch.zeros((ny, 2, n), dtype=torch.float32, device=dev),
        "ybu": torch.zeros((ny, 2 * r), dtype=torch.float32, device=dev),
        "pcpart": torch.empty((ny, nblk, r), dtype=torch.float64,
                              device=dev),
        "flags": torch.zeros((nb, FLAG_SLOTS + max(num_steps, 1)),
                             dtype=torch.int32, device=dev)}


def affine_args(ao: AffineOperands, bufs: dict, rb_extra, num_steps: int,
                num_iterations: int, rebase_every: int, variant: str, plan,
                stream=None, counts=None, launched=None):
    """The arguments of csrc/affine.cu's C entry point (``AFFINE_ENTRY``,
    typed by ``_ARGTYPES``) for one call over the sims of the buffers
    ``bufs`` (:func:`affine_buffers`): the kernel's mode of ``variant``,
    the grid's nb sims (one cluster each in its cluster launches), the
    projection order, the staging plan's bits and bytes a block, the
    device counters' block ``counts`` and the host int64 ``launched`` that
    takes the number of kernels the call enqueues (None: neither)."""
    ro, fo = ao.res, ao.fused
    b0, flags = bufs["b0"], bufs["flags"]
    nb = b0.shape[0] if b0.dim() == 3 else 1
    rb_rows, rb_sim = rb_layout(rb_extra)
    mode = _VARIANTS[variant] if ro.floor else 0
    p = _build.ptr
    return (*(p(bufs[k]) for k in ("b0", "b1", "fa")), p(rb_extra),
            p(ro.U_liftT), p(ro.ut_acT), p(ao.M_utac), p(ao.U_selT),
            p(fo.C_allT), p(fo.inv3), p(fo.WT_all), p(fo.gptr), p(fo.gcol),
            p(fo.gw), p(fo.elem_kind), p(fo.elem_g), p(fo.elem_f),
            *(p(bufs[k]) for k in ("coef", "bu", "sn", "Pm", "u", "partial",
                                   "ys", "ybu", "pcpart", "flags")),
            ro.n, fo.r, ro.n_sel, fo.g_total, fo.m_total, int(num_steps),
            int(num_iterations), int(rebase_every), mode, nb,
            flags.shape[-1], ro.dt, ro.eta, ao.floor_level, rb_rows, rb_sim,
            p(fo.lane_cols), fo.lane_cols.numel(), plan.bits,
            plan.smem_bytes, stream, counts,
            None if launched is None else ctypes.byref(launched))


def _launch_affine(ao: AffineOperands, P, V, fext, rb_extra,
                   num_steps: int, num_iterations: int, rebase_every: int,
                   variant: str):
    """Enqueue one call of csrc/affine.cu, ``variant`` "lean" or "contact"
    (kernel 3's builds) or "exit" (kernel 4), on the (3, N) state, or the
    (B, 3, N) states of B sims -> (P', V', flags, coef, y): coef holds the
    coefficients (:func:`split_coef`) over the last anchors, which are the
    inputs P, V when no rebase fell in the call; y is contact mode's
    (Py, Vy, buPy, buVy) of the contact variant with the floor on, else
    None; flags, coef and y have a leading sim axis when the state has.
    The kernels it enqueues count in ``device.launches``.  A launch the
    card refuses (a cluster that cannot be placed with the
    plan's shared memory, a plan whose bytes differ from the kernel's
    carving) raises."""
    ro, fo = ao.res, ao.fused
    check_state(ro, P, V, fext, rb_extra)
    if rebase_every < 1:
        raise ValueError("rebase_every must be >= 1")
    batched = P.dim() == 3
    nb = P.shape[0] if batched else 1
    fn = _build.function("affine", _SYMBOLS[(P.dtype, ro.U_liftT.dtype)],
                         _ARGTYPES)
    bufs = affine_buffers(ao, P, V, fext, num_steps, variant, affine_tile())
    launched = ctypes.c_longlong(0)
    code = fn(*affine_args(ao, bufs, rb_extra, num_steps, num_iterations,
                           rebase_every, variant, affine_plan(ao, nb),
                           _build.stream_of(P.device),
                           device_counts_ptr(P.device), launched))
    count("device.launches", launched.value)
    _build.check("affine", code, "resident_affine")
    r, flags, coef = fo.r, bufs["flags"], bufs["coef"]
    ys, ybu = bufs["ys"], bufs["ybu"]
    contact = ys.shape[0] > 0
    y = (ys[:, 0], ys[:, 1], ybu[:, :r], ybu[:, r:]) if contact else None
    if not batched:
        flags, coef = flags[0], coef[0]
        y = tuple(x[0] for x in y) if contact else None
    return bufs["b0"], bufs["b1"], flags, coef, y


def _kernel3(wrapper, variant: str, batched: bool, ao: AffineOperands, P, V,
             fext, rb_extra, num_steps: int, num_iterations: int,
             rebase_every: int):
    """Kernel 3's wrappers: the plain version on CPU tensors; on CUDA
    tensors one call of csrc/affine.cu, counted in ``wrapper.launches``."""
    if batched and P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return resident_affine_plain(ao, P, V, fext, rb_extra, num_steps,
                                     num_iterations, rebase_every,
                                     contact_mode=variant == "contact")
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if not batched and P.dim() != 2:
        raise ValueError("P must be (3, N): a batch of sims takes "
                         f"{wrapper.__name__}_batched")
    out = _launch_affine(ao, P, V, fext, rb_extra, num_steps, num_iterations,
                         rebase_every, variant)[:2]
    wrapper.launches += 1
    return out


def resident_affine(ao: AffineOperands, P, V, fext, rb_extra,
                    num_steps: int, num_iterations: int,
                    rebase_every: int = 256):
    """Kernel 3, the lean build: (P', V') after ``num_steps`` steps from the
    permuted (3, N) state.  CPU tensors run the plain version; CUDA tensors
    launch ``csrc/affine.cu`` on the current stream, or raise.  The inputs
    are not modified."""
    return _kernel3(resident_affine, "lean", False, ao, P, V, fext, rb_extra,
                    num_steps, num_iterations, rebase_every)


resident_affine.launches = 0


def resident_affine_batched(ao: AffineOperands, P, V, fext, rb_extra,
                            num_steps: int, num_iterations: int,
                            rebase_every: int = 256):
    """The batched build of kernel 3 (lean): (P', V') (B, 3, N) of B
    independent sims after ``num_steps`` steps from their permuted
    (B, 3, N) states and forces, the target-term schedule ``rb_extra``
    shared or per sim.  The contact branch is per sim.  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/affine.cu`` with B sims, or
    raise.  The inputs are not modified."""
    return _kernel3(resident_affine_batched, "lean", True, ao, P, V, fext,
                    rb_extra, num_steps, num_iterations, rebase_every)


resident_affine_batched.launches = 0


def resident_affine_contact(ao: AffineOperands, P, V, fext, rb_extra,
                            num_steps: int, num_iterations: int,
                            rebase_every: int = 256):
    """Kernel 3, the contact-mode build: (P', V') after ``num_steps`` steps
    from the permuted (3, N) state; a clamped step enters contact mode,
    which the next rebase leaves.  CPU tensors run the plain version; CUDA
    tensors launch the contact variant of ``csrc/affine.cu`` on the current
    stream, or raise.  The inputs are not modified."""
    return _kernel3(resident_affine_contact, "contact", False, ao, P, V,
                    fext, rb_extra, num_steps, num_iterations, rebase_every)


resident_affine_contact.launches = 0


def resident_affine_contact_batched(ao: AffineOperands, P, V, fext,
                                    rb_extra, num_steps: int,
                                    num_iterations: int,
                                    rebase_every: int = 256):
    """The batched build of kernel 3 in contact mode: (P', V') (B, 3, N) of
    B independent sims, each with its own mode (:func:`resident_affine_
    contact` per sim, ``rb_extra`` shared or per sim).  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/affine.cu`` with B sims, or
    raise.  The inputs are not modified."""
    return _kernel3(resident_affine_contact_batched, "contact", True, ao, P,
                    V, fext, rb_extra, num_steps, num_iterations,
                    rebase_every)


resident_affine_contact_batched.launches = 0


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
        raise ValueError("P must be (3, N): a batch of sims takes "
                         "resident_affine_exit_batched")
    P_out, V_out, flags, _, _ = _launch_affine(ao, P, V, fext, rb_extra,
                                               num_steps, num_iterations,
                                               rebase_every, "exit")
    resident_affine_exit.launches += 1
    count_bytes("transfer.d2h_bytes", flags[2])
    return P_out, V_out, int(flags[2])


resident_affine_exit.launches = 0


def resident_affine_exit_batched(ao: AffineOperands, P, V, fext, rb_extra,
                                 num_steps: int, num_iterations: int,
                                 rebase_every: int = 256):
    """The batched build of kernel 4 (``nb = B`` in the JAX package):
    (P', V', k) of B independent sims (B, 3, N), the target-term schedule
    ``rb_extra`` shared or per sim, with the JAX kernel's whole-batch exit:
    every sim is committed to the same k steps, those before the first step
    at which any sim's predictor the floor would clamp.  CPU tensors run
    the plain version; CUDA tensors launch the exit variant of
    ``csrc/affine.cu`` with B sims, one cluster each, every sim stopping at
    its own first clamp (its own k_b), and read the B values of k_b back.
    When they differ, the call is launched again for k = min k_b steps from
    the same inputs (``ops/affine_chunked.py`` ``_chunk_cuda_batched``'s
    method): no cluster waits for another, and the launch is deterministic,
    so each sim's state is that of its first k steps bit for bit.  Each
    launch counts in ``launches``.  The inputs are not modified."""
    if P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return resident_affine_exit_plain(ao, P, V, fext, rb_extra,
                                          num_steps, num_iterations,
                                          rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    call = (ao, P, V, fext, rb_extra)
    P_out, V_out, flags, _, _ = _launch_affine(
        *call, num_steps, num_iterations, rebase_every, "exit")
    resident_affine_exit_batched.launches += 1
    count_bytes("transfer.d2h_bytes", flags[:, 2])
    kb = flags[:, 2].tolist()
    k = min(kb)
    if k < max(kb):
        P_out, V_out = _launch_affine(*call, k, num_iterations, rebase_every,
                                      "exit")[:2]
        resident_affine_exit_batched.launches += 1
    return P_out, V_out, k


resident_affine_exit_batched.launches = 0
register_launches(resident_affine, resident_affine_batched,
                  resident_affine_contact, resident_affine_contact_batched,
                  resident_affine_exit, resident_affine_exit_batched)


def affine_tile() -> int:
    """Vertices per block of the O(N) launches of csrc/affine.cu."""
    return int(_build.function("affine", "affine_tile", ())())
