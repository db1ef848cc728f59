"""Kernel 5: the chunked affine tier 1.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``build_resident_affine_chunked`` (the chunk kernel ``_make_chunk_kernel``
and its outer loop ``_body``), ``nb=1``, static targets, with the JAX
defaults ``floor_bound_skip``, ``floor_exact``, ``fold_vc``, ``static_rb``
and ``sqrt_free_bound`` on (the port takes no switch for the others).

The chunk kernel carries only coefficient state: up to ``rebase_every``
contact-free affine steps on (3, 3) base coefficients and (3, r) reduced
coordinates over the anchors P, V of the chunk.  Each step tests the floor
first with an O(r) Cauchy-Schwarz bound on the y row of the predictor,

    min_v sn_y[v] >= lb_aff - ||wsn_y|| umax,

``lb_aff`` from the min/max of the anchors' and the force term's y rows,
with 25 % slack on the lift term (tested on squared magnitudes); only when
the bound cannot clear the floor does it materialize the exact y row.  The
first step the floor would clamp stops the chunk without being applied.
The gathered vertex values come straight from the coefficients through the
G-composed operands (``Vc = a0 b0s + a1 b1s + a2 fas + wsn UG``).

Between chunks the outer loop (Python, here) materializes the chunk's end
state with two lifts, makes it the next chunk's anchors and projects them
through ``U^T A_c`` (float64 accumulation, as in ``ops/resident.py``).  It
reads ``k`` back once per chunk and stops after a chunk that exited early.

* ``affine_chunked``: the wrapper.  For CUDA tensors it runs the outer
  loop with the chunk kernel ``csrc/affine_chunked.cu``, counting each chunk
  launch in ``affine_chunked.launches``; for CPU tensors it runs the plain
  version; it never falls back from the card to the plain version.
* ``affine_chunked_plain``: the outer loop with ``affine_chunk_plain``, the
  plain transcription of the chunk kernel.

ADVICE r5 (``pallas_resident.py:1600-1608``): the chunk takes the y-row
minima and maxima of the bound once per chunk for the anchors and, in the
first chunk of a call only, for the force term.
"""

from __future__ import annotations

import ctypes

import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.affine import (
    AffineContext,
    AffineOperands,
    split_coef,
)
from animsnapbases_tpu_torch.ops.fused_reduced import rowvec_bmm
from animsnapbases_tpu_torch.ops.resident import (
    check_state,
    force_term,
    lift_coords,
    project,
)

# the bound's slack: 25 % of the lift term, and a relative epsilon
BOUND_SLACK = 1.25
BOUND_EPS = 1e-6


def affine_chunk_plain(ao: AffineOperands, P, V, fa, ymm, first: bool,
                       b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                       num_iterations: int, floor_h: float):
    """Plain version of the chunk kernel: up to ``steps`` steps from unit
    coefficients over the anchors P, V -> (ap, av, wp, wv, k).

    ``b0s``, ``b1s``, ``fas`` (3, g_total): P, V, fa at the gathered
    columns; ``bu0``, ``bu1``, ``bu_fa`` (3, r): their projections.  ``ymm``
    (6,) holds the minima, then the maxima, of the y rows of P, V and fa:
    the chunk writes those of P and V, and those of fa when ``first``.
    The step itself is ``AffineContext``'s (ops/affine.py); what is the
    chunk's own is the O(r) bound, the exact y-row check on a trip and the
    gathered values through ``UG_allT``."""
    ymm[0::3] = y_minmax(P[1])
    ymm[1::3] = y_minmax(V[1])
    if first:
        ymm[2::3] = y_minmax(fa[1])
    ctx = AffineContext(ao, fa, bu_fa)
    st = ctx.init_anchors(P, V)
    st.bu0, st.bu1 = bu0, bu1
    c2 = (BOUND_SLACK * ao.umax) * (BOUND_SLACK * ao.umax)
    ymn, ymx = ymm[:3], ymm[3:]
    k = 0
    for i in range(steps):
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        a = asn[1]
        lb_aff = torch.where(a >= 0, a * ymn, a * ymx).sum()
        wn2 = (wsn[1] * wsn[1]).sum()
        m = lb_aff - floor_h - BOUND_EPS * (1.0 + lb_aff.abs())
        if bool((m < 0) | (m * m < c2 * wn2)):
            # the bound cannot clear the floor: the exact y row
            if bool((ctx.y_predictor(st, asn, wsn) < floor_h).any()):
                break
        ctx.gathered_step(st, asn, wsn, avd, wp,
                          gathered_values(ao, asn, wsn, b0s, b1s, fas), rb_ex,
                          num_iterations)
        k = i + 1
    return st.ap, st.av, st.wp, st.wv, k


def gathered_values(ao: AffineOperands, asn, wsn, b0s, b1s, fas):
    """The predictor's gathered values Vc (3, g_total) straight from its
    coefficients through the G-composed operands."""
    return (asn[:, 0:1] * b0s + asn[:, 1:2] * b1s + asn[:, 2:3] * fas
            + rowvec_bmm(wsn, ao.fused.UG_allT))


def y_minmax(x):
    """(min, max) of a row, as a (2,) tensor."""
    mn, mx = torch.aminmax(x)
    return torch.stack([mn, mx])


def chunk_anchors(ao: AffineOperands, P, V):
    """What the outer loop prepares for one chunk from its anchors: their
    projections (bu0, bu1) and their gathered columns (b0s, b1s)."""
    ro, gidx = ao.res, ao.fused.gidx.long()
    return project(ro, P), project(ro, V), P[:, gidx], V[:, gidx]


def advance(ao: AffineOperands, P, V, fa, ap, av, wp, wv):
    """The chunk's end state from its coefficients -> (P', V')."""
    ro = ao.res
    return (ap[:, 0:1] * P + ap[:, 1:2] * V + ap[:, 2:3] * fa
            + lift_coords(ro, wp),
            av[:, 0:1] * P + av[:, 1:2] * V + av[:, 2:3] * fa
            + lift_coords(ro, wv))


def _drive(chunk, ao: AffineOperands, P, V, fext, rb_extra, num_steps: int,
           num_iterations: int, rebase_every: int):
    """The outer loop around ``chunk`` -> (P', V', steps_done)."""
    if rebase_every < 1:
        raise ValueError("rebase_every must be >= 1")
    ro = ao.res
    fa = force_term(ro, fext)
    fas = fa[:, ao.fused.gidx.long()]     # fa_sel G_allT: a column gather
    bu_fa = project(ro, fa)
    ymm = torch.empty(6, dtype=P.dtype, device=P.device)
    done = 0
    while done < num_steps:
        bu0, bu1, b0s, b1s = chunk_anchors(ao, P, V)
        steps = min(rebase_every, num_steps - done)
        ap, av, wp, wv, k = chunk(ao, P, V, fa, ymm, done == 0, b0s, b1s,
                                  fas, bu0, bu1, bu_fa, rb_extra, steps,
                                  num_iterations, ao.floor_level)
        P, V = advance(ao, P, V, fa, ap, av, wp, wv)
        done += k
        if k < steps:
            break
    return P, V, done


def affine_chunked_plain(ao: AffineOperands, P, V, fext, rb_extra,
                         num_steps: int, num_iterations: int,
                         rebase_every: int = 1024):
    """Plain version of kernel 5: the outer loop with the plain chunk ->
    (P', V', steps_done)."""
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return _drive(affine_chunk_plain, ao, P, V, fext, rb_extra, num_steps,
                  num_iterations, rebase_every)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_SYMBOLS = {
    (torch.float32, torch.float32): "affine_chunk_f32_f32",
    (torch.float32, torch.bfloat16): "affine_chunk_f32_bf16",
}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = (_P,) * 23 + (_I,) * 7 + (_D,) * 5 + (_P,)


def _chunk_cuda(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
                fas, bu0, bu1, bu_fa, rb_ex, steps: int, num_iterations: int,
                floor_h: float):
    """One launch of csrc/affine_chunked.cu; reads k back (4 bytes)."""
    ro, fo = ao.res, ao.fused
    fn = _build.function("affine_chunked",
                         _SYMBOLS[(P.dtype, ro.U_liftT.dtype)], _ARGTYPES)
    r = fo.r
    out = torch.empty(2 * 9 + 2 * 3 * r, dtype=P.dtype, device=P.device)
    k = torch.zeros(1, dtype=torch.int32, device=P.device)
    p = _build.ptr
    code = fn(p(P), p(V), p(fa), p(ymm), p(b0s), p(b1s), p(fas), p(bu0),
              p(bu1), p(bu_fa), p(rb_ex), p(ro.U_liftT), p(ao.M_utac),
              p(fo.UG_allT), p(fo.C_allT), p(fo.inv3), p(fo.WT_all),
              p(fo.gidx), p(fo.elem_kind), p(fo.elem_g), p(fo.elem_f),
              p(out), p(k), ro.n, r, fo.g_total, fo.m_total, int(steps),
              int(num_iterations), int(first), ro.dt, ro.eta,
              float(floor_h), (BOUND_SLACK * ao.umax) ** 2, BOUND_EPS,
              _build.stream_of(P.device))
    _build.check("affine_chunked", code, "affine_chunked")
    affine_chunked.launches += 1
    return (*split_coef(out, r), int(k.item()))


def affine_chunked(ao: AffineOperands, P, V, fext, rb_extra, num_steps: int,
                   num_iterations: int, rebase_every: int = 1024):
    """Kernel 5: (P', V', steps_done) after up to ``num_steps`` contact-free
    steps from the permuted (3, N) state.  CPU tensors run the plain
    version; CUDA tensors run the outer loop with
    ``csrc/affine_chunked.cu``, or raise.  The inputs are not modified."""
    if P.device.type == "cpu":
        return affine_chunked_plain(ao, P, V, fext, rb_extra, num_steps,
                                    num_iterations, rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    check_state(ao.res, P, V, fext, rb_extra)
    return _drive(_chunk_cuda, ao, P.contiguous(), V.contiguous(), fext,
                  rb_extra.contiguous(), num_steps, num_iterations,
                  rebase_every)


affine_chunked.launches = 0
