"""Kernel 1: the fully-reduced PD local-global iteration loop of one step.

Counterpart of ``animsnapbases_tpu/ops/pallas_reduced.py``.  It holds
the host-side packing (``pack_tris_strain``, ``pack_edge_spring``,
``prepare_fused_operands``, the same arrays the JAX package builds, with
the same float64 precomposition of ``C_allT = usel_inv G_allT`` and
``inv3``), the row-form projection emitters (``_tri_p``, ``_spring_p``),
and the loop itself three ways:

* ``fused_reduced_iterations``: the wrapper.  For a CUDA tensor it
  launches the hand-written kernel ``csrc/fused_reduced.cu`` and counts the
  launch in ``fused_reduced_iterations.launches``; for a CPU tensor it
  runs the plain version; it never falls back from the card to the plain
  version.
* ``fused_reduced_iterations_batched``: the batched build (the JAX kernel
  under ``vmap``, ``make_batched_step``): the same kernel on a grid of one
  block per sim, counted in its own ``launches``.
* ``fused_reduced_iterations_plain``: the plain PyTorch version, a
  transcription of the JAX loop (``build_fused_reduced_iterations``); a
  leading batch axis of sims (B, 3, ·) makes it the batched build's plain
  version.
* ``iterate_plain``: the loop body, shared with ``ops/resident.py``.

The kernel does not read the JAX package's per-group layout.  It reads an
element table built here by ``fused_operands`` from that layout: one
column per projection row, with its kind, the Vall columns of its vertex
slots and its rest data.  The plain version reads the same table, so the
CPU tests check the table the kernel reads.

Only the ``tris_strain`` and ``edge_spring`` kinds in DEIM row form are
ported; the tet and bending kinds and block form raise
``NotImplementedError`` (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.strain2d import clamped_fhat_2x2

PORTED_KINDS = ("tris_strain", "edge_spring")
KIND_CODES = {"tris_strain": 0, "edge_spring": 1}   # csrc/iteration.cuh
ELEM_ROWS = 13


def _onehot(rows: np.ndarray, n_cols: int, dtype) -> np.ndarray:
    m = len(rows)
    g = np.zeros((m, n_cols), dtype=dtype)
    g[np.arange(m), rows] = 1
    return g


def pack_tris_strain(subset_data: dict, lookup: np.ndarray, W: np.ndarray,
                     row_select: np.ndarray, dtype) -> dict:
    """Host-side packing of a selected tri-strain group in row form:
    ``row_select`` (m,) picks one of the 2 projection rows per element,
    W (3, r, m).  ``lookup`` maps global vertex id -> selected-union
    index."""
    if row_select is None:
        raise NotImplementedError(
            "block-form tris_strain groups are not ported yet "
            "(ROADMAP Queue A item 9)")
    faces = lookup[np.asarray(subset_data["faces"])]
    n_sel = int(lookup.max()) + 1 if len(lookup) else 0
    P = np.asarray(subset_data["P"])          # (m, 3, 2)
    D = np.asarray(subset_data["DmInv"])      # (m, 2, 2)
    arrays = [
        P[:, :, 0].T.astype(dtype),                    # P0T (3, m)
        P[:, :, 1].T.astype(dtype),                    # P1T (3, m)
        np.stack([D[:, 0, 0], D[:, 0, 1],
                  D[:, 1, 0], D[:, 1, 1]]).astype(dtype),   # (4, m)
        (row_select % 2 == 0).astype(dtype)[None, :],  # row_is0 (1, m)
    ]
    return {
        "kind": "tris_strain",
        "block": False,
        "gathers": [_onehot(faces[:, k], n_sel, dtype) for k in range(3)],
        "arrays": arrays,
        "WT": np.ascontiguousarray(W.transpose(0, 2, 1)).astype(dtype),
        "smin": float(subset_data["sigma_min"]),
        "smax": float(subset_data["sigma_max"]),
    }


def pack_edge_spring(subset_data: dict, lookup: np.ndarray, W: np.ndarray,
                     dtype) -> dict:
    edges = lookup[np.asarray(subset_data["edges"])]
    n_sel = int(lookup.max()) + 1 if len(lookup) else 0
    rest = np.asarray(subset_data["rest_length"]).astype(dtype)
    return {
        "kind": "edge_spring",
        "gathers": [_onehot(edges[:, k], n_sel, dtype) for k in range(2)],
        "arrays": [rest[None, :]],                         # (1, m)
        "WT": np.ascontiguousarray(W.transpose(0, 2, 1)).astype(dtype),
    }


def prepare_fused_operands(groups: list[dict], U_selT: np.ndarray,
                           inv3: np.ndarray) -> dict:
    """Merged gather matrix, merged rhs matrix, inverse-folded lift and
    layout metadata, as the JAX package's ``prepare_fused_operands``
    builds them.  ``C_allT = usel_inv G_allT`` and ``UG_allT = U_selT
    G_allT`` are precomposed HERE in float64 (inv(Ar) spans ~10 decades with 1e10 pinned masses), and the
    loop keeps the rb sum in r-space: folding ``usel_inv`` into ``WT``
    instead diverges numerically."""
    dtype = U_selT.dtype
    flat_arrays, layout, wt_blocks = [], [], []
    gather_blocks, gather_slices = [], []
    g_off = 0
    for g in groups:
        layout.append((g["kind"], len(g["arrays"]), g.get("smin"),
                       g.get("smax"), g.get("prevent_flips", True),
                       g.get("block", False)))
        flat_arrays.extend(g["arrays"])
        wt_blocks.append(np.asarray(g["WT"]))
        slices = []
        for gm in g["gathers"]:
            gm = np.asarray(gm)
            gather_blocks.append(gm)
            slices.append((g_off, gm.shape[0]))
            g_off += gm.shape[0]
        gather_slices.append(slices)
    WT_all = np.concatenate(wt_blocks, axis=1).astype(dtype)
    G_all64 = np.concatenate(gather_blocks, axis=0).astype(np.float64)
    G_allT = np.ascontiguousarray(G_all64.T).astype(dtype)
    inv64 = np.asarray(inv3, dtype=np.float64)
    uselinv64 = np.stack(
        [inv64[d] @ np.asarray(U_selT[d], dtype=np.float64)
         for d in range(3)])
    C_allT = np.stack([uselinv64[d] @ G_all64.T
                       for d in range(3)]).astype(dtype)
    # U_selT G_allT, the map from reduced coordinates to gathered vertex
    # values that the chunked affine kernel reads (ops/affine_chunked.py)
    UG_allT = np.stack([np.asarray(U_selT[d], dtype=np.float64) @ G_all64.T
                        for d in range(3)]).astype(dtype)
    return {
        "layout": layout,
        "gather_slices": gather_slices,
        "flat_arrays": flat_arrays,
        "WT_all": WT_all,
        "G_allT": G_allT,
        "C_allT": C_allT,
        "UG_allT": UG_allT,
        "inv3": inv64.astype(dtype),
    }


@dataclass(frozen=True)
class FusedOperands:
    """The loop's operands on one device, in one dtype."""
    C_allT: torch.Tensor     # (3, r, g_total)
    inv3: torch.Tensor       # (3, r, r)
    WT_all: torch.Tensor     # (3, m_total, r)
    gidx: torch.Tensor       # (g_total,) int32: Vc[:, c] = snT_sel[:, gidx[c]]
    elem_kind: torch.Tensor  # (m_total,) int32
    elem_g: torch.Tensor     # (3, m_total) int32 Vall column per vertex slot
    elem_f: torch.Tensor     # (ELEM_ROWS, m_total) rest data
    segments: tuple          # ((kind, first column, m, smin, smax), ...)
    UG_allT: torch.Tensor    # (3, r, g_total) U_selT G_allT

    @property
    def r(self) -> int:
        return self.inv3.shape[1]

    @property
    def g_total(self) -> int:
        return self.C_allT.shape[2]

    @property
    def m_total(self) -> int:
        return self.WT_all.shape[1]


def fused_operands(ops: dict, device, dtype) -> FusedOperands:
    """Cast ``prepare_fused_operands``' arrays (the port's or the JAX
    package's) once to ``dtype`` on ``device`` and build the element
    table the kernel reads."""
    G = np.asarray(ops["G_allT"], dtype=np.float64)      # (n_sel, g_total)
    if not (((G == 0) | (G == 1)).all() and ((G == 1).sum(0) == 1).all()):
        raise ValueError("G_allT is not one-hot: only gather groups "
                         "(tris_strain, edge_spring) are ported")
    gidx = G.argmax(axis=0)
    m_total = np.asarray(ops["WT_all"]).shape[1]
    kind = np.zeros(m_total, np.int32)
    eg = np.zeros((3, m_total), np.int32)
    ef = np.zeros((ELEM_ROWS, m_total))
    segments = []
    col = 0
    off = 0
    for (name, cnt, smin, smax, _pflips, block), slices in zip(
            ops["layout"], ops["gather_slices"]):
        arrs = [np.asarray(a, dtype=np.float64)
                for a in ops["flat_arrays"][off:off + cnt]]
        off += cnt
        if name not in PORTED_KINDS or block:
            raise NotImplementedError(
                f"{name} ({'block' if block else 'row'} form) is not "
                "ported yet (ROADMAP Queue A item 9)")
        m = slices[0][1]
        cols = slice(col, col + m)
        kind[cols] = KIND_CODES[name]
        for s, (start, length) in enumerate(slices):
            assert length == m
            eg[s, cols] = start + np.arange(m)
        if name == "tris_strain":
            P0T, P1T, Dm, row_is0 = arrs
            ef[0:3, cols] = P0T
            ef[3:6, cols] = P1T
            ef[6:10, cols] = Dm
            ef[10, cols] = row_is0[0]
            ef[11, cols] = smin
            ef[12, cols] = smax
        else:
            ef[0, cols] = arrs[0][0]
        segments.append((name, col, m, smin, smax))
        col += m
    if col != m_total:
        raise ValueError(f"layout covers {col} of {m_total} rhs columns")

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    return FusedOperands(
        C_allT=t(np.asarray(ops["C_allT"], np.float64)),
        inv3=t(np.asarray(ops["inv3"], np.float64)),
        WT_all=t(np.asarray(ops["WT_all"], np.float64)),
        gidx=t(gidx, torch.int32), elem_kind=t(kind, torch.int32),
        elem_g=t(eg, torch.int32), elem_f=t(ef),
        segments=tuple(segments),
        UG_allT=t(np.asarray(ops["UG_allT"], np.float64)))


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _sum_dims(x, y):
    """sum_d x[d] * y[d] for (..., 3, m) rows."""
    return (x[..., 0:1, :] * y[..., 0:1, :] + x[..., 1:2, :] * y[..., 1:2, :]
            + x[..., 2:3, :] * y[..., 2:3, :])


def _tri_p(gathered, arrays, smin, smax):
    """Pre-gathered vertex slices -> one projection row per element,
    (3, m) (pallas_reduced.py ``_tri_p``, row form)."""
    V1, V2, V3 = gathered
    P0T, P1T, Dm, row_is0 = arrays
    e1 = V2 - V1
    e2 = V3 - V1
    a_ = _sum_dims(P0T, e1)
    b_ = _sum_dims(P0T, e2)
    c_ = _sum_dims(P1T, e1)
    d_ = _sum_dims(P1T, e2)
    D00, D01, D10, D11 = Dm[0:1], Dm[1:2], Dm[2:3], Dm[3:4]
    f00, f01, f10, f11 = clamped_fhat_2x2(
        a_ * D00 + b_ * D10, a_ * D01 + b_ * D11,
        c_ * D00 + d_ * D10, c_ * D01 + d_ * D11, smin, smax)
    fh0 = torch.where(row_is0 > 0, f00, f01)
    fh1 = torch.where(row_is0 > 0, f10, f11)
    return P0T * fh0 + P1T * fh1                       # (3, m)


def _spring_p(gathered, arrays):
    """(pallas_reduced.py ``_spring_p``)."""
    V0, V1 = gathered
    (rest,) = arrays
    spring = V1 - V0                                   # (..., 3, m)
    length = torch.sqrt(spring[..., 0:1, :] ** 2 + spring[..., 1:2, :] ** 2
                        + spring[..., 2:3, :] ** 2)    # (..., 1, m)
    keep = length > 0
    inv_len = torch.where(keep, 1.0 / torch.clamp(length, min=1e-30),
                          torch.zeros_like(length))
    delta = 0.5 * (length - rest)
    return torch.where(keep, 0.5 * spring - delta * inv_len * spring,
                       torch.zeros_like(spring))


def _projection_rows(fo: FusedOperands, Vall):
    """pT (..., 3, m_total): every element's projection row, read from the
    element table."""
    eg = fo.elem_g.long()
    ef = fo.elem_f
    parts = []
    for name, c0, m, smin, smax in fo.segments:
        cols = slice(c0, c0 + m)
        if name == "tris_strain":
            gathered = [Vall[..., eg[s, cols]] for s in range(3)]
            arrays = [ef[0:3, cols], ef[3:6, cols], ef[6:10, cols],
                      ef[10:11, cols]]
            parts.append(_tri_p(gathered, arrays, smin, smax))
        else:
            gathered = [Vall[..., eg[s, cols]] for s in range(2)]
            parts.append(_spring_p(gathered, [ef[0:1, cols]]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def rowvec_bmm(x, mats):
    """Per dim d: x[..., d, :] (k,) @ mats[d] (k, n) -> (..., 3, n).  A
    batch of sims (B, 3, k) contracts as one product per dim over the B
    rows, without copying ``mats`` per sim."""
    return torch.einsum("...dk,dkn->...dn", x, mats).contiguous()


def iterate_plain(fo: FusedOperands, Vc, rb_const, num_iterations: int):
    """The loop carried in rb (..., 3, r) from the hoisted Vc
    (..., 3, g_total), a leading batch axis being independent sims:
    ``Vall = Vc + rb C_allT``, projection rows, ``rb = rb_const + pT WT``.
    Returns the last rb."""
    rb = torch.zeros_like(rb_const)
    for _ in range(num_iterations):
        Vall = Vc + rowvec_bmm(rb, fo.C_allT)
        pT = _projection_rows(fo, Vall)
        rb = rb_const + rowvec_bmm(pT, fo.WT_all)
    return rb


def solve_plain(fo: FusedOperands, rb):
    """u = rb inv3 per dim (inv(Ar) is symmetric: row form)."""
    return rowvec_bmm(rb, fo.inv3)


def fused_reduced_iterations_plain(fo: FusedOperands, snT_sel, rb_const,
                                   num_iterations: int):
    """Plain version of kernel 1: u (..., 3, r) from snT_sel (..., 3, n_sel)
    and rb_const (..., 3, r); a leading axis is a batch of sims (the plain
    version of the batched build).  ``Vc = snT_sel G_allT`` is the index
    gather that the one-hot product equals exactly."""
    if snT_sel.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    Vc = snT_sel[..., fo.gidx.long()]
    return solve_plain(fo, iterate_plain(fo, Vc, rb_const, num_iterations))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _P)


def _check_cuda_operands(fo: FusedOperands, tensors: dict):
    dev = fo.C_allT.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, operands on {dev}")
        if t.dtype != fo.C_allT.dtype:
            raise TypeError(f"{name} is {t.dtype}, operands are "
                            f"{fo.C_allT.dtype}")


def _launch_fused(fo: FusedOperands, snT_sel, rb_const, num_iterations: int):
    """One launch of csrc/fused_reduced.cu over the sims of the leading
    axis of snT_sel (..., 3, n_sel) and rb_const (..., 3, r) -> u."""
    if snT_sel.device.type != "cuda":
        raise ValueError(f"unsupported device {snT_sel.device}")
    r, g, m = fo.r, fo.g_total, fo.m_total
    if fo.C_allT.dtype != torch.float32:
        raise TypeError("the kernel runs float32 state only, got "
                        f"{fo.C_allT.dtype}")
    _check_cuda_operands(fo, {"snT_sel": snT_sel, "rb_const": rb_const})
    lead = tuple(snT_sel.shape[:-2])
    if (snT_sel.dim() not in (2, 3) or snT_sel.shape[-2] != 3
            or snT_sel.stride(-1) != 1):
        raise ValueError("snT_sel must be (3, n_sel) or (B, 3, n_sel) with "
                         "unit column stride")
    if tuple(rb_const.shape) != lead + (3, r) or not rb_const.is_contiguous():
        raise ValueError(f"rb_const must be contiguous {lead + (3, r)}")
    nb = lead[0] if lead else 1
    sim_sn = int(snT_sel.stride(0)) if lead else 0
    u = torch.empty(lead + (3, r), dtype=rb_const.dtype,
                    device=rb_const.device)
    fn = _build.function("fused_reduced", "fused_reduced_iterations_f32",
                         _ARGTYPES)
    code = fn(_build.ptr(snT_sel), int(snT_sel.stride(-2)), sim_sn,
              _build.ptr(rb_const), _build.ptr(fo.C_allT),
              _build.ptr(fo.inv3), _build.ptr(fo.WT_all),
              _build.ptr(fo.gidx), _build.ptr(fo.elem_kind),
              _build.ptr(fo.elem_g), _build.ptr(fo.elem_f), _build.ptr(u),
              r, g, m, int(num_iterations), nb,
              _build.stream_of(rb_const.device))
    _build.check("fused_reduced", code, "fused_reduced_iterations")
    return u


def fused_reduced_iterations(fo: FusedOperands, snT_sel, rb_const,
                             num_iterations: int):
    """u (3, r) after ``num_iterations`` of the loop.  A CPU tensor runs the
    plain version; a CUDA tensor launches ``csrc/fused_reduced.cu`` (one
    thread block) on the current stream, or raises."""
    if snT_sel.device.type == "cpu":
        return fused_reduced_iterations_plain(fo, snT_sel, rb_const,
                                              num_iterations)
    if snT_sel.dim() != 2:
        raise ValueError("snT_sel must be (3, n_sel): a batch of sims takes "
                         "fused_reduced_iterations_batched")
    u = _launch_fused(fo, snT_sel, rb_const, num_iterations)
    fused_reduced_iterations.launches += 1
    return u


fused_reduced_iterations.launches = 0


def fused_reduced_iterations_batched(fo: FusedOperands, snT_sel, rb_const,
                                     num_iterations: int):
    """The batched build of kernel 1: u (B, 3, r) of B independent sims from
    snT_sel (B, 3, n_sel) and rb_const (B, 3, r).  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/fused_reduced.cu`` on a grid
    of B blocks, one sim each, or raise."""
    if snT_sel.dim() != 3:
        raise ValueError("snT_sel must be (B, 3, n_sel)")
    if snT_sel.device.type == "cpu":
        return fused_reduced_iterations_plain(fo, snT_sel, rb_const,
                                              num_iterations)
    u = _launch_fused(fo, snT_sel, rb_const, num_iterations)
    fused_reduced_iterations_batched.launches += 1
    return u


fused_reduced_iterations_batched.launches = 0
