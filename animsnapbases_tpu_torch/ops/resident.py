"""Kernel 2: the standard resident multi-step loop.

Counterpart of ``animsnapbases_tpu/ops/pallas_resident.py``
``build_resident_multistep``.  Vertices are
permuted so that the selected-element union is a prefix of the vertex axis
(the solver applies ``perm`` at entry and ``iperm`` at exit of
``run_steps``), so the iteration loop reads ``snT_sel`` as ``sn[:, :n_sel]``.

* ``resident_multistep``: the wrapper.  For CUDA tensors it launches the
  hand-written kernel ``csrc/resident.cu`` (three launches per step,
  enqueued by one C loop; the step's loop runs on one cluster of three
  blocks per sim, on the staging plan of :func:`resident_plan`) and counts
  the call in
  ``resident_multistep.launches``; for CPU tensors it runs the plain
  version; it never falls back from the card to the plain version.
* ``resident_multistep_batched``: the batched build (``nb = B`` in the JAX
  package): B independent sims in one call of the same C loop, counted in
  its own ``launches``.  It serves the contact windows of
  ``make_batched_run``'s large-model route.
* ``resident_multistep_plain``: the plain PyTorch version, a
  transcription of the JAX kernel's step; with a leading batch axis it is
  the batched build's plain version.

The batched layout is sim-major: the states of B sims are (B, 3, N), sim b's
(3, N) block contiguous, where the JAX package keeps dim-major (3B, N) rows
d*B + b.  Sim-major gives each sim's kernel work one base offset.
* ``step_once`` (``predict``, the loop, ``lift``): one step of that
  transcription with the iteration loop passed in, which
  ``AnimSnapBasesSolver.step`` runs on kernel 1.

The positional-target term ``rb_extra = U^T S^T targets`` of every kernel
here and in ``ops/affine.py`` and ``ops/affine_chunked.py`` is a schedule
(the JAX kernels' (T*3nb, r) ``rb_seq``): a static (3, r) row, a (T, 3, r)
schedule that the sims share, or a (B, T, 3, r) schedule per sim.  Step i
of a call reads row min(i, T - 1) (:func:`rb_at`); a schedule that has
ended repeats its last row.  The kernels read it as one pointer with T rows
and a sim stride (0 when shared: no B-fold copy), row t of sim b at
``b * stride + t * 3r`` (:func:`rb_layout`).

As in the JAX kernel, sn and u are rounded to the storage dtype of the big
(3, r, N) matrices before they meet them, and products accumulate in the
working dtype, except ``U^T A_c sn``, which kernel and plain version both
accumulate in float64 (the JAX kernel sums it in its working dtype; see
ROADMAP Queue C).  With bfloat16 storage the plain version reads the same
bfloat16-rounded values, so kernel and plain version differ only in the
order of their sums.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.cluster import launch_plan
from animsnapbases_tpu_torch.ops.fused_reduced import (
    FusedOperands,
    fused_reduced_iterations_plain,
    rowvec_bmm,
)
from animsnapbases_tpu_torch.utils.profiling import count, register_launches


@dataclass(frozen=True)
class ResidentOperands:
    """Everything one resident run needs besides the state."""
    fused: FusedOperands
    U_liftT: torch.Tensor    # (3, r, N) storage dtype, permuted vertices
    ut_acT: torch.Tensor     # (3, r, N) storage dtype, (U^T A_c) permuted
    mass_inv: torch.Tensor   # (1, N) working dtype, permuted
    perm: np.ndarray         # selected union first
    iperm: np.ndarray
    n_sel: int
    dt: float
    eta: float               # 1 - damping
    floor: bool
    floor_h: float

    @property
    def n(self) -> int:
        return self.U_liftT.shape[2]


def resident_operands(fused: FusedOperands, U_liftT, ut_acT, mass_inv,
                      perm, iperm, n_sel: int, dt: float, eta: float,
                      floor: bool, floor_h: float,
                      matmul_dtype=None) -> ResidentOperands:
    """Cast the host (numpy, float64) resident operands once to the fused
    operands' device and dtype; the big matrices to ``matmul_dtype``
    (default: the working dtype)."""
    device, dtype = fused.C_allT.device, fused.C_allT.dtype
    mm = dtype if matmul_dtype is None else matmul_dtype

    def big(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64),
                               device=device).to(mm).contiguous()

    return ResidentOperands(
        fused=fused, U_liftT=big(U_liftT), ut_acT=big(ut_acT),
        mass_inv=torch.as_tensor(
            np.asarray(mass_inv, np.float64).reshape(1, -1), dtype=dtype,
            device=device),
        perm=np.asarray(perm), iperm=np.asarray(iperm), n_sel=int(n_sel),
        dt=float(dt), eta=float(eta), floor=bool(floor),
        floor_h=float(floor_h))


def force_term(ro: ResidentOperands, fext):
    """fa = dt^2 fext / m, constant over a call: (..., 3, N)."""
    return ro.dt * ro.dt * fext * ro.mass_inv


def storage_round(x, mm):
    return x if x.dtype == mm else x.to(mm).to(x.dtype)


def project(ro: ResidentOperands, X):
    """``U^T A_c X`` (..., 3, r) of a (..., 3, N) state (NT contraction over
    N), with X rounded to the storage dtype first.  Accumulated in float64
    and rounded back, as csrc/resident.cu does: the N terms cancel to ~4e-4
    of their absolute sum.  A batch (B, 3, N) is one product per dim with
    the B states as columns."""
    Xm = storage_round(X, ro.ut_acT.dtype).double()
    proj = torch.einsum("dkn,...dn->...dk", ro.ut_acT.double(), Xm)
    return proj.to(X.dtype).contiguous()


def lift_coords(ro: ResidentOperands, w):
    """``U w`` (..., 3, N) of reduced coordinates w (..., 3, r), with w
    rounded to the storage dtype first; accumulated in the working dtype."""
    wm = storage_round(w, ro.U_liftT.dtype)
    return rowvec_bmm(wm, ro.U_liftT.to(w.dtype))


def predict(ro: ResidentOperands, P, V, fa, rb_extra):
    """The damped predictor with the y-row floor clamp, and
    ``rb_const = rb_extra - U^T A_c sn`` -> (sn, rb_const)."""
    sn = P + ro.dt * ro.eta * V + fa
    if ro.floor:
        sn = sn.clone()
        y = sn[..., 1, :]
        sn[..., 1, :] = torch.where(y < ro.floor_h,
                                    torch.full_like(y, ro.floor_h), y)
    return sn, rb_extra - project(ro, sn)


def lift(ro: ResidentOperands, P, sn, u):
    """``q = sn + U u`` and ``V = (q - P)/dt`` -> (q, V)."""
    q = sn + lift_coords(ro, u)
    return q, (q - P) / ro.dt


def step_once(ro: ResidentOperands, P, V, fa, rb_extra, num_iterations,
              iterate=fused_reduced_iterations_plain):
    """One full step on the permuted (..., 3, N) state -> (q, V_new), with
    the iteration loop ``iterate`` (the plain version by default)."""
    sn, rb_const = predict(ro, P, V, fa, rb_extra)
    u = iterate(ro.fused, sn[..., :ro.n_sel], rb_const, num_iterations)
    return lift(ro, P, sn, u)


def rb_at(rb_extra, i: int):
    """The target term of step ``i`` of a schedule -> (..., 3, r): a static
    (3, r) term itself, else row min(i, T - 1) of a (T, 3, r) schedule, or
    of each sim's (B, T, 3, r) schedule ((B, 3, r))."""
    if rb_extra.dim() == 2:
        return rb_extra
    return rb_extra[..., min(i, rb_extra.shape[-3] - 1), :, :]


def rb_from(rb_extra, start: int):
    """The schedule as a call that starts at its step ``start`` reads it:
    its row min(start, T - 1) first (a view)."""
    if rb_extra.dim() == 2 or start == 0:
        return rb_extra
    return rb_extra[..., min(start, rb_extra.shape[-3] - 1):, :, :]


def rb_layout(rb_extra):
    """(rows T, sim stride in elements) of a schedule as the kernels read
    it: row t of sim b at ``b * stride + t * 3r`` from its first element."""
    if rb_extra.dim() == 2:
        return 1, 0
    if rb_extra.dim() == 3:
        return rb_extra.shape[0], 0
    return rb_extra.shape[1], rb_extra.stride(0)


def resident_multistep_plain(ro: ResidentOperands, P, V, fext, rb_extra,
                             num_steps: int, num_iterations: int):
    """Plain version of kernel 2: ``num_steps`` steps -> (P', V'), step i
    with the target term ``rb_at(rb_extra, i)``.  With a leading batch axis
    (B, 3, N) of independent sims (``rb_extra`` shared or per sim) it is the
    plain version of the batched build."""
    if P.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    fa = force_term(ro, fext)
    for i in range(num_steps):
        P, V = step_once(ro, P, V, fa, rb_at(rb_extra, i), num_iterations)
    return P, V


_SYMBOLS = {
    (torch.float32, torch.float32): "resident_multistep_f32_f32",
    (torch.float32, torch.bfloat16): "resident_multistep_f32_bf16",
}
_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_ARGTYPES = ((_P,) * 18 + (_I,) * 7 + (_D, _D, _I, _D, _I, _L, _P)
             + (_I,) * 3 + (_P, _P))


def check_state(ro: ResidentOperands, P, V, fext, rb_extra):
    """Raise unless P, V, fext (3, N), or (B, 3, N) for a batch of B sims,
    and the target-term schedule rb_extra ((3, r), (T, 3, r) or, for a
    batch, (B, T, 3, r), each (3, r) row contiguous) lie on the operands'
    device in their working dtype, and a kernel takes that state dtype
    beside the operands' storage dtype (float32 state; float32 or bfloat16
    storage).  Returns (state dtype, storage dtype)."""
    fo = ro.fused
    dev, dtype = fo.C_allT.device, fo.C_allT.dtype
    lead = tuple(P.shape[:-2])
    if len(lead) > 1 or (lead and lead[0] < 1):
        raise ValueError(f"P must be (3, N) or (B, 3, N), got "
                         f"{tuple(P.shape)}")
    state = lead + (3, ro.n)
    for name, t, shape in (("P", P, state), ("V", V, state),
                           ("fext", fext, state),
                           ("rb_extra", rb_extra, tuple(rb_extra.shape))):
        if t.device != dev or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    T = rb_extra.shape[-3] if rb_extra.dim() > 2 else 1
    if T < 1 or tuple(rb_extra.shape) not in {
            (3, fo.r), (T, 3, fo.r), lead + (T, 3, fo.r)}:
        raise ValueError(f"rb_extra must be (3, r), (T, 3, r) or, for a "
                         f"batch of B sims, (B, T, 3, r); got "
                         f"{tuple(rb_extra.shape)} beside P "
                         f"{tuple(P.shape)}")
    if (rb_extra.stride(-1) != 1 or rb_extra.stride(-2) != fo.r
            or (rb_extra.dim() > 2 and rb_extra.stride(-3) != 3 * fo.r)):
        raise ValueError("each (3, r) row of rb_extra must be contiguous")
    key = (dtype, ro.ut_acT.dtype)
    if key not in _SYMBOLS:
        raise TypeError(f"no kernel for state/storage {key}")
    return key


def resident_plan(ro: ResidentOperands, nb: int = 1, clusters=None):
    """The staging plan (ops/cluster.py) the iteration launch of
    csrc/resident.cu runs on for nb sims (:func:`~animsnapbases_tpu_torch.
    ops.cluster.launch_plan`: the full plan for one sim; for a batch, the
    plan that needs the fewest waves of clusters on the card)."""
    fo = ro.fused
    return launch_plan("resident", "resident", nb, fo.r, fo.g_total,
                       fo.m_total, clusters=clusters)


def resident_args(ro: ResidentOperands, P, V, fa, rb_extra, sn, partial, u,
                  num_steps: int, num_iterations: int, plan, stream=None,
                  launched=None):
    """The arguments of csrc/resident.cu's C entry point
    (``RESIDENT_ENTRY``, typed by ``_ARGTYPES``) for one call over the sims
    of the leading axis of the state P, V (updated in place) into the
    buffers sn, partial and u: the grid's nb sims (one cluster each in the
    iteration launch), the projection order, the staging plan's bits and
    bytes a block, and the host int64 ``launched`` that takes the number of
    kernels the call enqueues (None: not counted)."""
    fo = ro.fused
    nb = P.shape[0] if P.dim() == 3 else 1
    rb_rows, rb_sim = rb_layout(rb_extra)
    p = _build.ptr
    return (p(P), p(V), p(fa), p(rb_extra), p(ro.U_liftT), p(ro.ut_acT),
            p(fo.C_allT), p(fo.inv3), p(fo.WT_all), p(fo.gptr), p(fo.gcol),
            p(fo.gw), p(fo.elem_kind), p(fo.elem_g), p(fo.elem_f), p(sn),
            p(partial), p(u), ro.n, fo.r, fo.g_total, fo.m_total,
            int(num_steps), int(num_iterations), nb, ro.dt, ro.dt * ro.eta,
            int(ro.floor), ro.floor_h, rb_rows, rb_sim, p(fo.lane_cols),
            fo.lane_cols.numel(), plan.bits, plan.smem_bytes, stream,
            None if launched is None else ctypes.byref(launched))


def _launch_resident(ro: ResidentOperands, P, V, fext, rb_extra,
                     num_steps: int, num_iterations: int):
    """One call of csrc/resident.cu over the (3, N) state or the (B, 3, N)
    states of B sims -> (P', V'), the kernels it enqueues counted in
    ``device.launches``.  A launch the card refuses (a cluster that cannot
    be placed with the plan's shared memory, a plan whose bytes differ from
    the kernel's carving) raises."""
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    key = check_state(ro, P, V, fext, rb_extra)
    fo = ro.fused
    dtype = fo.C_allT.dtype
    n, r = ro.n, fo.r
    nb = P.shape[0] if P.dim() == 3 else 1
    fn = _build.function("resident", _SYMBOLS[key], _ARGTYPES)
    tile = resident_tile()
    P_out = P.contiguous().clone()
    V_out = V.contiguous().clone()
    fa = force_term(ro, fext).contiguous()
    sn = torch.empty_like(P_out)
    # per-sim, per-tile partials of U^T A_c sn, accumulated in float64
    # (resident.cu)
    partial = torch.empty((nb, (n + tile - 1) // tile, 3, r),
                          dtype=torch.float64, device=P.device)
    u = torch.empty((nb, 3, r), dtype=dtype, device=P.device)
    launched = ctypes.c_longlong(0)
    code = fn(*resident_args(ro, P_out, V_out, fa, rb_extra, sn, partial, u,
                             num_steps, num_iterations,
                             resident_plan(ro, nb),
                             _build.stream_of(P.device), launched))
    count("device.launches", launched.value)
    _build.check("resident", code, "resident_multistep")
    return P_out, V_out


def resident_multistep(ro: ResidentOperands, P, V, fext, rb_extra,
                       num_steps: int, num_iterations: int):
    """(P', V') after ``num_steps`` steps of ``num_iterations`` iterations
    from the permuted (3, N) state, step i with the target term row
    ``rb_at(rb_extra, i)``.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/resident.cu`` on the current stream, or
    raise.  The inputs are not modified."""
    if P.device.type == "cpu":
        return resident_multistep_plain(ro, P, V, fext, rb_extra, num_steps,
                                        num_iterations)
    if P.dim() != 2:
        raise ValueError("P must be (3, N): a batch of sims takes "
                         "resident_multistep_batched")
    out = _launch_resident(ro, P, V, fext, rb_extra, num_steps,
                           num_iterations)
    resident_multistep.launches += 1
    return out


resident_multistep.launches = 0


def resident_multistep_batched(ro: ResidentOperands, P, V, fext, rb_extra,
                               num_steps: int, num_iterations: int):
    """The batched build of kernel 2: (P', V') (B, 3, N) of B independent
    sims after ``num_steps`` steps, from their permuted (B, 3, N) states and
    forces, with the target-term schedule ``rb_extra`` shared ((3, r) or
    (T, 3, r)) or per sim ((B, T, 3, r)).  CPU tensors
    run the plain version; CUDA tensors launch ``csrc/resident.cu`` with B
    sims (each (3, r, N) matrix read once per tile for a group of sims), or
    raise.  The inputs are not modified."""
    if P.dim() != 3:
        raise ValueError("P must be (B, 3, N)")
    if P.device.type == "cpu":
        return resident_multistep_plain(ro, P, V, fext, rb_extra, num_steps,
                                        num_iterations)
    out = _launch_resident(ro, P, V, fext, rb_extra, num_steps,
                           num_iterations)
    resident_multistep_batched.launches += 1
    return out


resident_multistep_batched.launches = 0
register_launches(resident_multistep, resident_multistep_batched)


def resident_tile() -> int:
    """Vertices per block of the predictor/projection launch."""
    return int(_build.function("resident", "resident_tile", ())())
