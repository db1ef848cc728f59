"""Kernel 5: the chunked affine tier 1.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``build_resident_affine_chunked`` (the chunk kernel ``_make_chunk_kernel``
and its outer loop ``_body``), with the JAX defaults ``floor_bound_skip``,
``floor_exact``, ``fold_vc`` and ``sqrt_free_bound`` on (the port takes no
switch for them: ROADMAP B5).  The target term is a schedule
(``ops/resident.py`` :func:`rb_at`): the outer loop hands each chunk the
schedule from the chunk's first step on, so step j of a chunk that starts
at step ``done`` of the call reads row min(done + j, T - 1).  A static term
(T = 1) is the JAX ``static_rb``.

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
* ``affine_chunked_batched``: the batched build (``nb = B`` in the JAX
  package), the tier 1 of ``make_batched_run``'s large-model route: B
  independent sims, sim-major (B, 3, N), one block per sim's chunk, with
  whole-batch early exit (counted in its own ``launches``).
* ``affine_chunked_plain``: the outer loop with ``affine_chunk_plain``, the
  plain transcription of the chunk kernel; on (B, 3, N) tensors the plain
  version of the batched build.

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
from animsnapbases_tpu_torch.ops.fused_reduced import gather_vc, rowvec_bmm
from animsnapbases_tpu_torch.ops.resident import (
    check_state,
    force_term,
    lift_coords,
    project,
    rb_at,
    rb_from,
    rb_layout,
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
    columns; ``bu0``, ``bu1``, ``bu_fa`` (3, r): their projections;
    ``rb_ex`` the target-term schedule from the chunk's first step (step i
    takes ``rb_at(rb_ex, i)``).  ``ymm``
    (6,) holds the minima, then the maxima, of the y rows of P, V and fa:
    the chunk writes those of P and V, and those of fa when ``first``.
    The step itself is ``AffineContext``'s (ops/affine.py); what is the
    chunk's own is the O(r) bound, the exact y-row check on a trip and the
    gathered values through ``UG_allT``.

    With a leading batch axis (B, ·) on every per-sim argument (``ymm``
    (B, 6)) it is the plain version of the batched build: each sim tests its
    own bound and y row, and the chunk stops for the whole batch before the
    first step at which any sim would clamp, so every sim is committed to
    the same k (the minimum of the sims' own k)."""
    ymm[..., 0::3] = y_minmax(P[..., 1, :])
    ymm[..., 1::3] = y_minmax(V[..., 1, :])
    if first:
        ymm[..., 2::3] = y_minmax(fa[..., 1, :])
    ctx = AffineContext(ao, fa, bu_fa)
    st = ctx.init_anchors(P, V)
    st.bu0, st.bu1 = bu0, bu1
    c2 = (BOUND_SLACK * ao.umax) * (BOUND_SLACK * ao.umax)
    ymn, ymx = ymm[..., :3], ymm[..., 3:]
    k = 0
    for i in range(steps):
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        a = asn[..., 1, :]
        lb_aff = torch.where(a >= 0, a * ymn, a * ymx).sum(-1)
        wn2 = (wsn[..., 1, :] * wsn[..., 1, :]).sum(-1)
        m = lb_aff - floor_h - BOUND_EPS * (1.0 + lb_aff.abs())
        maybe = (m < 0) | (m * m < c2 * wn2)
        if bool(maybe.any()):
            # the bound cannot clear the floor: the exact y row
            hit = (ctx.y_predictor(st, asn, wsn) < floor_h).any(-1)
            if bool((hit & maybe).any()):
                break
        ctx.gathered_step(st, asn, wsn, avd, wp,
                          gathered_values(ao, asn, wsn, b0s, b1s, fas),
                          rb_at(rb_ex, i), num_iterations)
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


def chunk_anchors(ao: AffineOperands, P, V):
    """What the outer loop prepares for one chunk from its anchors: their
    projections (bu0, bu1) and their gathered columns (b0s, b1s)."""
    ro, fo = ao.res, ao.fused
    return project(ro, P), project(ro, V), gather_vc(fo, P), gather_vc(fo, V)


def advance(ao: AffineOperands, P, V, fa, ap, av, wp, wv):
    """The chunk's end state from its coefficients -> (P', V')."""
    ro = ao.res
    return (ap[..., 0:1] * P + ap[..., 1:2] * V + ap[..., 2:3] * fa
            + lift_coords(ro, wp),
            av[..., 0:1] * P + av[..., 1:2] * V + av[..., 2:3] * fa
            + lift_coords(ro, wv))


def _drive(chunk, ao: AffineOperands, P, V, fext, rb_extra, num_steps: int,
           num_iterations: int, rebase_every: int):
    """The outer loop around ``chunk`` -> (P', V', steps_done), for one sim
    (3, N) or a batch (B, 3, N) whose chunks stop together."""
    if rebase_every < 1:
        raise ValueError("rebase_every must be >= 1")
    ro = ao.res
    fa = force_term(ro, fext)
    fas = gather_vc(ao.fused, fa)          # fa_sel G_allT
    bu_fa = project(ro, fa)
    ymm = P.new_empty(P.shape[:-2] + (6,))
    done = 0
    while done < num_steps:
        bu0, bu1, b0s, b1s = chunk_anchors(ao, P, V)
        steps = min(rebase_every, num_steps - done)
        ap, av, wp, wv, k = chunk(ao, P, V, fa, ymm, done == 0, b0s, b1s,
                                  fas, bu0, bu1, bu_fa,
                                  rb_from(rb_extra, done), steps,
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
_L = ctypes.c_longlong
_ARGTYPES = (_P,) * 25 + (_I,) * 8 + (_D,) * 5 + (_I, _L, _P)


def _chunk_launch(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
                  fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                  num_iterations: int, floor_h: float):
    """One launch of csrc/affine_chunked.cu over the sims of the leading
    axis (none: one sim) -> (coefficients (..., 18 + 6r), k per sim as an
    int32 tensor (...,))."""
    ro, fo = ao.res, ao.fused
    fn = _build.function("affine_chunked",
                         _SYMBOLS[(P.dtype, ro.U_liftT.dtype)], _ARGTYPES)
    r = fo.r
    lead = tuple(P.shape[:-2])
    for name, t in (("P", P), ("V", V), ("fa", fa), ("ymm", ymm),
                    ("b0s", b0s), ("b1s", b1s), ("fas", fas), ("bu0", bu0),
                    ("bu1", bu1), ("bu_fa", bu_fa)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_state(ro, P, V, fa, rb_ex)
    rb_rows, rb_sim = rb_layout(rb_ex)
    nb = lead[0] if lead else 1
    out = torch.empty(lead + (2 * 9 + 2 * 3 * r,), dtype=P.dtype,
                      device=P.device)
    k = torch.zeros(lead, dtype=torch.int32, device=P.device)
    p = _build.ptr
    code = fn(p(P), p(V), p(fa), p(ymm), p(b0s), p(b1s), p(fas), p(bu0),
              p(bu1), p(bu_fa), p(rb_ex), p(ro.U_liftT), p(ao.M_utac),
              p(fo.UG_allT), p(fo.C_allT), p(fo.inv3), p(fo.WT_all),
              p(fo.gptr), p(fo.gcol), p(fo.gw), p(fo.elem_kind),
              p(fo.elem_g), p(fo.elem_f),
              p(out), p(k), ro.n, r, fo.g_total, fo.m_total, int(steps),
              int(num_iterations), int(first), nb, ro.dt, ro.eta,
              float(floor_h), (BOUND_SLACK * ao.umax) ** 2, BOUND_EPS,
              rb_rows, rb_sim, _build.stream_of(P.device))
    _build.check("affine_chunked", code, "affine_chunked")
    return out, k


def _chunk_cuda(ao: AffineOperands, P, V, fa, ymm, first: bool, b0s, b1s,
                fas, bu0, bu1, bu_fa, rb_ex, steps: int, num_iterations: int,
                floor_h: float):
    """One launch of csrc/affine_chunked.cu for one sim; reads k back (4
    bytes)."""
    out, k = _chunk_launch(ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1,
                           bu_fa, rb_ex, steps, num_iterations, floor_h)
    affine_chunked.launches += 1
    return (*split_coef(out, ao.fused.r), int(k.item()))


def _chunk_cuda_batched(ao: AffineOperands, P, V, fa, ymm, first: bool,
                        b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex, steps: int,
                        num_iterations: int, floor_h: float):
    """The batched chunk, whole-batch exit: one launch runs every sim's
    chunk in its own block and records its own k_b (B int32 read back).
    When they differ, the chunk is launched again for k = min k_b steps
    from the same inputs; the launch is deterministic, so each sim's
    coefficients are those of the first k steps bit for bit.  (No block
    waits for another: a grid-wide barrier would hang when the blocks are
    not all resident.)"""
    launch = (ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex)
    out, kb = _chunk_launch(*launch, steps, num_iterations, floor_h)
    affine_chunked_batched.launches += 1
    kb = kb.tolist()
    k = min(kb)
    if k < max(kb):
        out, _ = _chunk_launch(*launch, k, num_iterations, floor_h)
        affine_chunked_batched.launches += 1
    return (*split_coef(out, ao.fused.r), k)


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
    if P.dim() != 2:
        raise ValueError("P must be (3, N): a batch of sims takes "
                         "affine_chunked_batched")
    check_state(ao.res, P, V, fext, rb_extra)
    return _drive(_chunk_cuda, ao, P.contiguous(), V.contiguous(), fext,
                  rb_extra, num_steps, num_iterations, rebase_every)


affine_chunked.launches = 0


def affine_chunked_batched(ao: AffineOperands, P, V, fext, rb_extra,
                           num_steps: int, num_iterations: int,
                           rebase_every: int = 1024):
    """The batched build of kernel 5: (P', V', k) of B independent sims
    (B, 3, N), the target-term schedule ``rb_extra`` shared or per sim, with
    whole-batch early exit: every sim is committed to the same k steps, the
    steps before the first one at which any sim would clamp.  CPU tensors
    run the plain version; CUDA tensors run the outer loop (one batched
    projection and lift of the anchors per chunk) with
    ``csrc/affine_chunked.cu`` on one block per sim, or raise.  The inputs
    are not modified."""
    if P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return affine_chunked_plain(ao, P, V, fext, rb_extra, num_steps,
                                    num_iterations, rebase_every)
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    check_state(ao.res, P, V, fext, rb_extra)
    return _drive(_chunk_cuda_batched, ao, P.contiguous(), V.contiguous(),
                  fext.contiguous(), rb_extra, num_steps, num_iterations,
                  rebase_every)


affine_chunked_batched.launches = 0
