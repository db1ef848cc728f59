"""Kernel 5: the chunked affine tier 1, in every build.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``build_resident_affine_chunked`` (the chunk kernel ``_make_chunk_kernel``
and its outer loop ``_body``) with its five build options
(:class:`ChunkOptions`, the JAX keywords ``floor_bound_skip``,
``floor_exact``, ``fold_vc``, ``static_rb`` and ``sqrt_free_bound``, each
on by default).  The target term is a schedule (``ops/resident.py``
:func:`rb_at`): the outer loop hands each chunk the schedule from the
chunk's first step on, so step j of a chunk that starts at step ``done`` of
the call reads row min(done + j, T - 1).

The chunk kernel carries only coefficient state: up to ``rebase_every``
contact-free affine steps on (3, 3) base coefficients and (3, r) reduced
coordinates over the anchors P, V of the chunk.  Each step tests the floor
first with an O(r) Cauchy-Schwarz bound on the y row of the predictor,

    min_v sn_y[v] >= lb_aff - ||wsn_y|| umax,

``lb_aff`` from the min/max of the anchors' and the force term's y rows,
with 25 % slack on the lift term (tested on squared magnitudes; with
``sqrt_free_bound=False`` on ||wsn_y|| itself).  Where it trips, the exact
builds try a second O(r) bound, per mode over the stored lift's y slice
(``AffineOperands.y_range``: each row's minimum lo_j and maximum hi_j over
the N vertices),

    min_v sn_y[v] >= lb_aff + sum_j min(w_j lo_j, w_j hi_j),

w the y coordinates rounded to the storage dtype as the exact row reads
them, with the slack 0.25 sum_j |w_j| max(|lo_j|, |hi_j|) + eps (1 +
|lb_aff|) (:func:`floor_bound`).  Both are lower bounds of the exact row,
so either one clearing certifies the step; only when both fail does the
chunk materialize the exact y row.  The first step the floor would clamp
stops the chunk without being applied.  The options:

* ``floor_exact=False`` (the exact-free build): a trip of the
  Cauchy-Schwarz bound *is* the stop (the JAX rule: no interval bound
  there, so its k stays the JAX package's), the kernel never reads the
  (r, N) y slice of the lift, and the outer loop
  takes the y rows' minima and maxima itself (exact in any order).  The
  caller rebases and re-enters, where the bound is as tight as it gets
  (``run_steps``' recursion), or serves the window on the contact tier.
  It requires the bound: ``floor_bound_skip=False`` with it raises.
* ``floor_bound_skip=False``: the exact y-row check every step.
* ``fold_vc=False``: the gathered values come from the predictor at the
  selected prefix (``U_selT``) through the sparse gather, as in kernels 3
  and 4; on (the default) straight from the coefficients through the
  G-composed operands (``Vc = a0 b0s + a1 b1s + a2 fas + wsn UG``).
* ``static_rb=False``: a one-row schedule is read per step like a longer
  one instead of being staged once (bit-identical values).
* ``sqrt_free_bound=False``: the bound with ``wn = sqrt(||wsn_y||^2)`` and
  slack 0.25 wn umax + eps (1 + |lb_aff|); it moves only when a check or a
  stop happens, by the last unit of rounding.

Between chunks the outer loop (Python, here) materializes the chunk's end
state with two lifts, makes it the next chunk's anchors and projects them
through ``U^T A_c`` (float64 accumulation, as in ``ops/resident.py``).  It
reads ``k`` back once per chunk and stops after a chunk that exited early.

* ``affine_chunked``: the wrapper.  For CUDA tensors it runs the outer
  loop with the chunk kernel of the options' build (``csrc/affine_chunked
  .cuh``, instantiated per option set in ``csrc/affine_chunked*.cu``: one
  cluster of three blocks, block d owning dimension d, on the staging plan
  of :func:`chunk_plan`), counting each chunk launch in the build's counter
  (:func:`counter`: the default build's is ``affine_chunked.launches``);
  for CPU tensors it runs the plain version;
  it never falls back from the card to the plain version or to another
  build.
* ``affine_chunked_batched``: the batched build (``nb = B`` in the JAX
  package), the tier 1 of ``make_batched_run``'s large-model route: B
  independent sims, sim-major (B, 3, N), one cluster per sim's chunk, with
  whole-batch early exit (counted in its own counters).
* ``affine_chunked_plain``: the outer loop with ``affine_chunk_plain``, the
  plain transcription of the chunk kernel; on (B, 3, N) tensors the plain
  version of the batched build.

ADVICE r5 (``pallas_resident.py:1600-1608``): the exact builds take the
y-row minima and maxima of the bound in the chunk, once per chunk for the
anchors and in the first chunk of a call only for the force term.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from dataclasses import dataclass

import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.affine import (
    AffineContext,
    AffineOperands,
    split_coef,
)
from animsnapbases_tpu_torch.ops.cluster import staging_plan
from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc, rowvec_bmm
from animsnapbases_tpu_torch.ops.resident import (
    check_state,
    force_term,
    lift_coords,
    project,
    rb_at,
    rb_from,
    rb_layout,
    storage_round,
)
from animsnapbases_tpu_torch.utils.profiling import (
    annotate,
    count,
    count_bytes,
    device_counts_ptr,
    register_launches,
)

# the bound's slack: 25 % of the lift term, and a relative epsilon
BOUND_SLACK = 1.25
BOUND_EPS = 1e-6
# the interval bound's slack: 25 % of its absolute lift sum
INTERVAL_SLACK = 0.25


@dataclass(frozen=True)
class ChunkOptions:
    """Kernel 5's build options, the JAX keywords of
    ``build_resident_affine_chunked`` with their defaults.  ``floor_exact``
    False requires ``floor_bound_skip`` (ValueError otherwise, as the JAX
    assert)."""
    floor_bound_skip: bool = True
    floor_exact: bool = True
    fold_vc: bool = True
    static_rb: bool = True
    sqrt_free_bound: bool = True

    def __post_init__(self):
        if not (self.floor_exact or self.floor_bound_skip):
            raise ValueError("floor_exact=False requires the certified floor "
                             "bound (floor_bound_skip=True)")

    def build(self) -> "ChunkOptions":
        """The kernel build that serves these options: without the bound
        ``sqrt_free_bound`` has nothing to choose and takes its default."""
        if self.floor_bound_skip:
            return self
        return dataclasses.replace(self, sqrt_free_bound=True)

    @property
    def code(self) -> int:
        """The build's template argument in csrc/affine_chunked.cuh
        (bits: bound 1, exact 2, fold 4, static 8, sqrt-free 16)."""
        b = self.build()
        return sum(bit for bit, on in (
            (1, b.floor_bound_skip), (2, b.floor_exact), (4, b.fold_vc),
            (8, b.static_rb), (16, b.sqrt_free_bound)) if on)

    @property
    def label(self) -> str:
        """The options that differ from the default, e.g.
        ``floor_exact=False`` ("" for the default build)."""
        b = self.build()
        return ",".join(f"{f.name}=False" for f in dataclasses.fields(b)
                        if not getattr(b, f.name))


DEFAULT_OPTIONS = ChunkOptions()
# every build a caller can reach: 8 exact, 8 exact-free, 4 without the bound
BUILDS = tuple(sorted({ChunkOptions(*bits).build()
                       for bits in itertools.product((True, False), repeat=5)
                       if bits[0] or bits[1]}, key=lambda o: -o.code))


def fill_ymm(ymm, P, V, fa, first: bool):
    """The bound's y-row minima (``ymm[..., :3]``) and maxima (``[3:]``) of
    P, V and, when ``first``, fa (..., 3, N); exact in any order."""
    ymm[..., 0::3] = y_minmax(P[..., 1, :])
    ymm[..., 1::3] = y_minmax(V[..., 1, :])
    if first:
        ymm[..., 2::3] = y_minmax(fa[..., 1, :])


def floor_bound(ao: AffineOperands, asn, wsn, ymm, floor_h: float,
                sqrt_free: bool, interval: bool = False):
    """Per sim, whether the O(r) bounds cannot clear the floor for the
    predictor (asn, wsn): ``lb_aff`` from the y rows' minima and maxima
    ``ymm`` against the lift term ``||wsn_y|| umax`` with its slack, and
    with ``interval`` (the exact builds), where that trips, the per-mode
    interval bound (:func:`interval_clears`); the steps the second bound
    clears count in ``k5.interval_clears``."""
    a = asn[..., 1, :]
    lb_aff = torch.where(a >= 0, a * ymm[..., :3], a * ymm[..., 3:]).sum(-1)
    wn2 = (wsn[..., 1, :] * wsn[..., 1, :]).sum(-1)
    if sqrt_free:
        c2 = (BOUND_SLACK * ao.umax) * (BOUND_SLACK * ao.umax)
        m = lb_aff - floor_h - BOUND_EPS * (1.0 + lb_aff.abs())
        trip = (m < 0) | (m * m < c2 * wn2)
    else:
        wn = torch.sqrt(wn2)
        slack = ((BOUND_SLACK - 1.0) * wn * ao.umax
                 + BOUND_EPS * (1.0 + lb_aff.abs()))
        trip = lb_aff - wn * ao.umax - slack < floor_h
    if not interval or not bool(trip.any()):
        return trip
    cleared = trip & interval_clears(ao, lb_aff, wsn, floor_h)
    count("k5.interval_clears", int(cleared.sum()))
    return trip & ~cleared


def interval_clears(ao: AffineOperands, lb_aff, wsn, floor_h: float):
    """Per sim, whether the per-mode interval bound clears the floor:
    ``lb_aff + sum_j min(w_j lo_j, w_j hi_j) - slack >= floor_h``, w the y
    coordinates rounded to the storage dtype (the values the exact row
    reads), lo, hi the rows of ``ao.y_range`` and the slack
    ``0.25 sum_j |w_j| max(-lo_j, hi_j) + eps (1 + |lb_aff|)``.  Each
    term bounds its mode's part of every vertex's lift from below, so in
    exact arithmetic the sum is at most the lift's minimum; the slack
    covers the rounding of the exact row's sum and of this one (each under
    r u sum_j |w_j| max(-lo_j, hi_j), u the unit roundoff), and
    ``eps (1 + |lb_aff|)`` the anchors' part, as in the Cauchy-Schwarz
    bound (csrc/affine_chunked.cuh)."""
    wy = storage_round(wsn[..., 1, :], ao.res.U_liftT.dtype)
    lo, hi = ao.y_range.to(wy.dtype)
    lift = torch.where(wy >= 0, wy * lo, wy * hi).sum(-1)
    spread = (wy.abs() * torch.maximum(-lo, hi)).sum(-1)
    slack = INTERVAL_SLACK * spread + BOUND_EPS * (1.0 + lb_aff.abs())
    return lb_aff + lift - slack >= floor_h


def affine_chunk_plain(ao: AffineOperands, P, V, fa, ymm, first: bool,
                       b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                       num_iterations: int, floor_h: float,
                       options: ChunkOptions = DEFAULT_OPTIONS):
    """Plain version of the chunk kernel: up to ``steps`` steps from unit
    coefficients over the anchors P, V -> (ap, av, wp, wv, k).

    ``b0s``, ``b1s``, ``fas`` (3, g_total): P, V, fa at the gathered
    columns (None without ``fold_vc``); ``bu0``, ``bu1``, ``bu_fa`` (3, r):
    their projections; ``rb_ex`` the target-term schedule from the chunk's
    first step (step i takes ``rb_at(rb_ex, i)``).  ``ymm`` (6,) holds the
    minima, then the maxima, of the y rows of P, V and fa: the exact build
    with the bound writes those of P and V, and those of fa when ``first``;
    the exact-free build reads all six (the outer loop wrote them).
    The step itself is ``AffineContext``'s (ops/affine.py); what is the
    chunk's own is the O(r) bounds (:func:`floor_bound`: in the exact
    builds the interval bound where the Cauchy-Schwarz one trips), the
    exact y-row check where they cannot clear the floor (every step without
    the bound) and the gathered values through ``UG_allT`` (through
    ``U_selT`` and the gather without ``fold_vc``).  It counts what the
    kernel counts (``utils/profiling.py``), per sim of a batch:
    ``k5.exact_checks``, the steps that ran the exact y-row check, and
    ``k5.interval_clears``, the steps the interval bound cleared after
    the Cauchy-Schwarz bound tripped.

    With a leading batch axis (B, ·) on every per-sim argument (``ymm``
    (B, 6)) it is the plain version of the batched build: each sim tests its
    own bound and y row, and the chunk stops for the whole batch before the
    first step at which any sim would clamp (or trips its bound, in the
    exact-free build), so every sim is committed to the same k (the minimum
    of the sims' own k)."""
    bound, exact = options.floor_bound_skip, options.floor_exact
    if bound and exact:
        fill_ymm(ymm, P, V, fa, first)
    ctx = AffineContext(ao, fa, bu_fa)
    st = ctx.init_anchors(P, V)
    st.bu0, st.bu1 = bu0, bu1
    k = 0
    for i in range(steps):
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        if bound:
            stop = floor_bound(ao, asn, wsn, ymm, floor_h,
                               options.sqrt_free_bound, interval=exact)
            if exact and bool(stop.any()):
                # the bound cannot clear the floor: the exact y row
                count("k5.exact_checks", int(stop.sum()))
                stop = stop & (ctx.y_predictor(st, asn, wsn)
                               < floor_h).any(-1)
        else:
            count("k5.exact_checks", ymm[..., 0].numel())
            stop = (ctx.y_predictor(st, asn, wsn) < floor_h).any(-1)
        if bool(stop.any()):
            break
        if options.fold_vc:
            ctx.gathered_step(st, asn, wsn, avd, wp,
                              gathered_values(ao, asn, wsn, b0s, b1s, fas),
                              rb_at(rb_ex, i), num_iterations)
        else:
            ctx.free_step(st, asn, wsn, avd, wp, rb_at(rb_ex, i),
                          num_iterations)
        k = i + 1
    return st.ap, st.av, st.wp, st.wv, k


def gathered_values(ao: AffineOperands, asn, wsn, b0s, b1s, fas):
    """The predictor's gathered values Vc (..., 3, g_total) straight from
    its coefficients through the G-composed operands."""
    return (asn[..., 0:1] * b0s + asn[..., 1:2] * b1s + asn[..., 2:3] * fas
            + rowvec_bmm(wsn, ao.fused.UG_allT))


def y_minmax(x):
    """(min, max) over the last axis of x, as a (..., 2) tensor."""
    mn, mx = torch.aminmax(x, dim=-1)
    return torch.stack([mn, mx], dim=-1)


def chunk_anchors(ao: AffineOperands, P, V, fold_vc: bool = True):
    """What the outer loop prepares for one chunk from its anchors: their
    projections (bu0, bu1) and, with ``fold_vc``, their gathered columns
    (b0s, b1s; else None)."""
    ro, fo = ao.res, ao.fused
    if not fold_vc:
        return project(ro, P), project(ro, V), None, None
    return project(ro, P), project(ro, V), gather_vc(fo, P), gather_vc(fo, V)


def advance(ao: AffineOperands, P, V, fa, ap, av, wp, wv):
    """The chunk's end state from its coefficients -> (P', V')."""
    ro = ao.res
    return (ap[..., 0:1] * P + ap[..., 1:2] * V + ap[..., 2:3] * fa
            + lift_coords(ro, wp),
            av[..., 0:1] * P + av[..., 1:2] * V + av[..., 2:3] * fa
            + lift_coords(ro, wv))


def _drive(chunk, ao: AffineOperands, P, V, fext, rb_extra, num_steps: int,
           num_iterations: int, rebase_every: int,
           options: ChunkOptions = DEFAULT_OPTIONS):
    """The outer loop around ``chunk`` -> (P', V', steps_done), for one sim
    (3, N) or a batch (B, 3, N) whose chunks stop together.  Spans
    (``utils/profiling.py``): ``asb.tier1`` around the loop, and per chunk
    ``asb.chunk.operands`` and ``asb.chunk.advance`` here, ``asb.chunk.
    launch`` and ``asb.chunk.readback`` in the card's chunk."""
    if rebase_every < 1:
        raise ValueError("rebase_every must be >= 1")
    ro = ao.res
    fold = options.fold_vc
    with annotate("asb.tier1"):
        with annotate("asb.chunk.operands"):
            fa = force_term(ro, fext)
            fas = gather_vc(ao.fused, fa) if fold else None  # fa_sel G_allT
            bu_fa = project(ro, fa)
            ymm = P.new_empty(P.shape[:-2] + (6,))
        done = 0
        while done < num_steps:
            with annotate("asb.chunk.operands"):
                bu0, bu1, b0s, b1s = chunk_anchors(ao, P, V, fold)
                if not options.floor_exact:
                    # the exact-free chunk has no O(N) operand: its bound's
                    # minima and maxima are taken here
                    fill_ymm(ymm, P, V, fa, done == 0)
            steps = min(rebase_every, num_steps - done)
            ap, av, wp, wv, k = chunk(ao, P, V, fa, ymm, done == 0, b0s, b1s,
                                      fas, bu0, bu1, bu_fa,
                                      rb_from(rb_extra, done), steps,
                                      num_iterations, ao.floor_level,
                                      options=options)
            with annotate("asb.chunk.advance"):
                P, V = advance(ao, P, V, fa, ap, av, wp, wv)
            done += k
            if k < steps:
                break
    return P, V, done


def affine_chunked_plain(ao: AffineOperands, P, V, fext, rb_extra,
                         num_steps: int, num_iterations: int,
                         rebase_every: int = 1024,
                         options: ChunkOptions = DEFAULT_OPTIONS):
    """Plain version of kernel 5 in the build of ``options``: the outer
    loop with the plain chunk -> (P', V', steps_done)."""
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return _drive(affine_chunk_plain, ao, P, V, fext, rb_extra, num_steps,
                  num_iterations, rebase_every, options)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_DTYPES = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.float32, torch.bfloat16): "f32_bf16",
}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_ARGTYPES = (_P,) * 27 + (_I,) * 9 + (_D,) * 6 + (_I, _L, _P) + (_I,) * 3 + (
    _P, _P)


def library(options: ChunkOptions) -> str:
    """The source (csrc/<name>.cu) whose library holds the build of
    ``options``: the default build, the exact-free builds, the others."""
    b = options.build()
    if b == DEFAULT_OPTIONS:
        return "affine_chunked"
    return "affine_chunked_free" if not b.floor_exact else "affine_chunked_opts"


def symbol(P_dtype, M_dtype, options: ChunkOptions) -> str:
    """The C entry point of the build of ``options`` for float ``P_dtype``
    state and ``M_dtype`` storage."""
    return f"affine_chunk_{_DTYPES[(P_dtype, M_dtype)]}_o{options.code}"


class LaunchCount:
    """A launch counter of one non-default build of kernel 5, beside the
    wrappers' own (``launches``; ``__name__`` names the build)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def chunk_plan(ao: AffineOperands, options: ChunkOptions = DEFAULT_OPTIONS):
    """The staging plan (ops/cluster.py) the chunk kernel of the build of
    ``options`` runs on for these operands."""
    fo = ao.fused
    return staging_plan("affine_chunked", fo.r, fo.g_total, fo.m_total,
                        ao.res.n_sel, fold_vc=options.fold_vc)


def counter(options: ChunkOptions, batched: bool):
    """The launch counter of the build of ``options``: the wrapper itself
    (``affine_chunked`` / ``affine_chunked_batched``) for the default
    build, else the build's :class:`LaunchCount`."""
    b = options.build()
    if b == DEFAULT_OPTIONS:
        return affine_chunked_batched if batched else affine_chunked
    return _COUNTERS[(b, batched)]


def chunk_args(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
               fas, bu0, bu1, bu_fa, rb_ex, steps: int, num_iterations: int,
               floor_h: float, out, k,
               options: ChunkOptions = DEFAULT_OPTIONS, stream=None,
               counts=None):
    """The arguments of the C entry point of the build of ``options``
    (csrc/affine_chunked.cuh ``CHUNK_ENTRY``, typed by ``_ARGTYPES``) for
    one launch over the sims of the leading axis (none: one sim) into
    ``out`` and ``k``: the grid's nb sims (one cluster each), the
    projection order, the staging plan's bits and bytes a block
    (:func:`chunk_plan`), and ``counts``, the device counters' block
    (``utils/profiling.py``; None: not counted).  The exact-free build gets
    no lift (its y slice is never read), and only the exact builds with
    the bound get the interval bound's ``y_range``.  Checks the inputs and
    raises on what the kernel does not take."""
    ro, fo = ao.res, ao.fused
    for name, t in (("P", P), ("V", V), ("fa", fa), ("ymm", ymm),
                    ("b0s", b0s), ("b1s", b1s), ("fas", fas), ("bu0", bu0),
                    ("bu1", bu1), ("bu_fa", bu_fa)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if options.fold_vc and b0s is None:
        raise ValueError("the fold_vc build takes the gathered columns")
    check_state(ro, P, V, fa, rb_ex)
    rb_rows, rb_sim = rb_layout(rb_ex)
    nb = P.shape[0] if P.dim() == 3 else 1
    plan = chunk_plan(ao, options)
    interval = options.floor_exact and options.floor_bound_skip
    p = _build.ptr

    def opt(t):
        return None if t is None else p(t)

    return (p(P), p(V), p(fa), p(ymm), opt(b0s), opt(b1s), opt(fas), p(bu0),
            p(bu1), p(bu_fa), p(rb_ex),
            p(ro.U_liftT) if options.floor_exact else None,
            p(ao.y_range) if interval else None, p(ao.M_utac),
            p(fo.UG_allT), p(ao.U_selT), p(fo.C_allT), p(fo.inv3),
            p(fo.WT_all), p(fo.gptr), p(fo.gcol), p(fo.gw), p(fo.elem_kind),
            p(fo.elem_g), p(fo.elem_f), p(out), p(k), ro.n, fo.r,
            fo.g_total, fo.m_total, ro.n_sel, int(steps),
            int(num_iterations), int(first), nb, ro.dt, ro.eta,
            float(floor_h), (BOUND_SLACK * ao.umax) ** 2, BOUND_EPS,
            ao.umax, rb_rows, rb_sim, p(fo.lane_cols), fo.lane_cols.numel(),
            plan.bits, plan.smem_bytes, stream, counts)


def _chunk_launch(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
                  fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                  num_iterations: int, floor_h: float,
                  options: ChunkOptions = DEFAULT_OPTIONS):
    """One launch of the build of ``options`` over the sims of the leading
    axis (none: one sim) -> (coefficients (..., 18 + 6r), k per sim as an
    int32 tensor (...,)): a grid of one cluster of three blocks per sim, on
    the staging plan of :func:`chunk_plan` (:func:`chunk_args`), counted in
    ``device.launches`` and adding to the device counters.  A launch the
    card refuses (a cluster that cannot be placed with the plan's shared
    memory) raises."""
    ro, r = ao.res, ao.fused.r
    lead = tuple(P.shape[:-2])
    out = torch.empty(lead + (2 * 9 + 2 * 3 * r,), dtype=P.dtype,
                      device=P.device)
    k = torch.zeros(lead, dtype=torch.int32, device=P.device)
    args = chunk_args(ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1,
                      bu_fa, rb_ex, steps, num_iterations, floor_h, out, k,
                      options, _build.stream_of(P.device),
                      device_counts_ptr(P.device))
    fn = _build.function(library(options),
                         symbol(P.dtype, ro.U_liftT.dtype, options),
                         _ARGTYPES)
    _build.check(library(options), fn(*args), "affine_chunked")
    count("device.launches")
    return out, k


def _chunk_cuda(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
                fas, bu0, bu1, bu_fa, rb_ex, steps: int, num_iterations: int,
                floor_h: float, options: ChunkOptions = DEFAULT_OPTIONS):
    """One launch of the chunk kernel for one sim; reads k back (4
    bytes)."""
    with annotate("asb.chunk.launch"):
        out, k = _chunk_launch(ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0,
                               bu1, bu_fa, rb_ex, steps, num_iterations,
                               floor_h, options)
        counter(options, False).launches += 1
    with annotate("asb.chunk.readback"):
        count_bytes("transfer.d2h_bytes", k)
        k = int(k.item())
    return (*split_coef(out, ao.fused.r), k)


def _chunk_cuda_batched(ao: AffineOperands, P, V, fa, ymm, first: bool,
                        b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                        num_iterations: int, floor_h: float,
                        options: ChunkOptions = DEFAULT_OPTIONS):
    """The batched chunk, whole-batch exit: one launch runs every sim's
    chunk in its own block and records its own k_b (B int32 read back).
    When they differ, the chunk is launched again for k = min k_b steps
    from the same inputs; the launch is deterministic, so each sim's
    coefficients are those of the first k steps bit for bit.  (No cluster
    waits for another: a grid-wide barrier would hang when the clusters
    are not all resident.)"""
    launch = (ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex)
    launches = counter(options, True)
    with annotate("asb.chunk.launch"):
        out, kb = _chunk_launch(*launch, steps, num_iterations, floor_h,
                                options)
        launches.launches += 1
    with annotate("asb.chunk.readback"):
        count_bytes("transfer.d2h_bytes", kb)
        kb = kb.tolist()
    k = min(kb)
    if k < max(kb):
        with annotate("asb.chunk.launch"):
            out, _ = _chunk_launch(*launch, k, num_iterations, floor_h,
                                   options)
            launches.launches += 1
    return (*split_coef(out, ao.fused.r), k)


def affine_chunked(ao: AffineOperands, P, V, fext, rb_extra, num_steps: int,
                   num_iterations: int, rebase_every: int = 1024,
                   options: ChunkOptions = DEFAULT_OPTIONS):
    """Kernel 5 in the build of ``options``: (P', V', steps_done) after up
    to ``num_steps`` contact-free steps from the permuted (3, N) state.  CPU
    tensors run the plain version; CUDA tensors run the outer loop with the
    build's chunk kernel, or raise.  The inputs are not modified."""
    if P.device.type == "cpu":
        return affine_chunked_plain(ao, P, V, fext, rb_extra, num_steps,
                                    num_iterations, rebase_every, options)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    if P.dim() != 2:
        raise ValueError("P must be (3, N): a batch of sims takes "
                         "affine_chunked_batched")
    check_state(ao.res, P, V, fext, rb_extra)
    return _drive(_chunk_cuda, ao, P.contiguous(), V.contiguous(), fext,
                  rb_extra, num_steps, num_iterations, rebase_every, options)


affine_chunked.launches = 0


def affine_chunked_batched(ao: AffineOperands, P, V, fext, rb_extra,
                           num_steps: int, num_iterations: int,
                           rebase_every: int = 1024,
                           options: ChunkOptions = DEFAULT_OPTIONS):
    """The batched build of kernel 5: (P', V', k) of B independent sims
    (B, 3, N), the target-term schedule ``rb_extra`` shared or per sim, with
    whole-batch early exit: every sim is committed to the same k steps, the
    steps before the first one at which any sim would clamp (trips its
    bound, in the exact-free build).  CPU tensors run the plain version;
    CUDA tensors run the outer loop (one batched projection and lift of the
    anchors per chunk) with the build's chunk kernel on one cluster per sim,
    or raise.  The inputs are not modified."""
    if P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return affine_chunked_plain(ao, P, V, fext, rb_extra, num_steps,
                                    num_iterations, rebase_every, options)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    check_state(ao.res, P, V, fext, rb_extra)
    return _drive(_chunk_cuda_batched, ao, P.contiguous(), V.contiguous(),
                  fext.contiguous(), rb_extra, num_steps, num_iterations,
                  rebase_every, options)


affine_chunked_batched.launches = 0

# the launch counters of the non-default builds, solo and batched
_COUNTERS = {
    (b, batched): LaunchCount(
        f"{'affine_chunked_batched' if batched else 'affine_chunked'}"
        f"[{b.label}]")
    for b in BUILDS if b != DEFAULT_OPTIONS for batched in (False, True)}
COUNTERS = tuple(_COUNTERS.values())
register_launches(affine_chunked, affine_chunked_batched, *COUNTERS)
