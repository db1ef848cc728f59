"""Kernel 1: the fully-reduced PD local-global iteration loop of one step.

Counterpart of ``animsnapbases_tpu/ops/pallas_reduced.py``.  It holds
the host-side packing (``pack_tris_strain``, ``pack_edge_spring``,
``pack_tets``, ``pack_verts_bending``, ``prepare_fused_operands``: the same
arrays the JAX package builds, with the same float64 precomposition of
``C_allT = usel_inv G_allT`` and ``inv3``), the projection emitters of
the five kinds (``_tri_p``, ``_spring_p``, ``_tet_p``, ``_bending_p``), and
the loop itself three ways:

* ``fused_reduced_iterations``: the wrapper.  For a CUDA tensor it
  launches the hand-written kernel ``csrc/fused_reduced.cu`` (the loop on
  one cluster of three blocks, ``csrc/iteration_cluster.cuh``, with the
  staging plan of ``ops/cluster.py``) and counts the launch in
  ``fused_reduced_iterations.launches``; for a CPU tensor it runs the
  plain version; it never falls back from the card to the plain version.
* ``fused_reduced_iterations_batched``: the batched build (the JAX kernel
  under ``vmap``, ``make_batched_step``): the same kernel on a grid of one
  cluster per sim, counted in its own ``launches``.
* ``fused_reduced_iterations_plain``: the plain PyTorch version, a
  transcription of the JAX loop (``build_fused_reduced_iterations``); a
  leading batch axis of sims (B, 3, ·) makes it the batched build's plain
  version.
* ``iterate_plain``: the loop body, shared with ``ops/resident.py``.

The kernel does not read the JAX package's per-group layout.  It reads an
element table built here by ``fused_operands`` from that layout: one
column per projection row, with its kind, the Vall columns of its vertex
slots and its rest data.  Block form (all p rows of each selected element,
``deim_pca_blocks`` / geom) is the same table: row k of an element is a
column with a fixed row, in the row-major block order of ``WT_all``
(``_block_major``).  The gather ``Vc = snT_sel G_allT`` is a sparse column
form of ``G_allT`` (``gather_vc``): one entry per one-hot column (tris,
springs, tets), the weighted star Laplacian of a bending column, summed in
float64.  The plain version reads the same table and the same sparse
columns, so the CPU tests check what the kernel reads.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from animsnapbases_tpu_torch.ops import _build
from animsnapbases_tpu_torch.ops.cluster import staging_plan
from animsnapbases_tpu_torch.ops.strain2d import clamped_fhat_2x2
from animsnapbases_tpu_torch.ops.strain3d import (
    polar_rotation,
    tet_strain_fhat,
)
from animsnapbases_tpu_torch.utils.profiling import count, register_launches

PORTED_KINDS = ("tris_strain", "edge_spring", "tets_strain",
                "tets_deformation_gradient", "verts_bending")
# the kind codes of csrc/iteration.cuh (KIND_TRI, ..., KIND_BENDING)
KIND_CODES = {name: code for code, name in enumerate(PORTED_KINDS)}
TET_KINDS = ("tets_strain", "tets_deformation_gradient")
ELEM_ROWS = 13
ELEM_SLOTS = 4


def _onehot(rows: np.ndarray, n_cols: int, dtype) -> np.ndarray:
    m = len(rows)
    g = np.zeros((m, n_cols), dtype=dtype)
    g[np.arange(m), rows] = 1
    return g


def _block_major(W: np.ndarray, p: int) -> np.ndarray:
    """Permute W (d, out, m*p) from element-major to row-major blocks (all
    elements' row 0, then row 1, ...), the order of the block emitters'
    columns."""
    d, out, mp = W.shape
    m = mp // p
    return np.ascontiguousarray(
        W.reshape(d, out, m, p).transpose(0, 1, 3, 2).reshape(d, out, mp))


def _wt(W: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(W.transpose(0, 2, 1)).astype(dtype)


def pack_tris_strain(subset_data: dict, lookup: np.ndarray, W: np.ndarray,
                     row_select: np.ndarray | None, dtype) -> dict:
    """Host-side packing of a selected tri-strain group: row form
    (``row_select`` (m,) picks one of the 2 projection rows per element, W
    (3, r, m)) or block form (``row_select`` None, W (3, r, 2m)
    element-major, permuted here to row-major blocks).  ``lookup`` maps
    global vertex id -> selected-union index."""
    faces = lookup[np.asarray(subset_data["faces"])]
    n_sel = int(lookup.max()) + 1 if len(lookup) else 0
    P = np.asarray(subset_data["P"])          # (m, 3, 2)
    D = np.asarray(subset_data["DmInv"])      # (m, 2, 2)
    block = row_select is None
    arrays = [
        P[:, :, 0].T.astype(dtype),                    # P0T (3, m)
        P[:, :, 1].T.astype(dtype),                    # P1T (3, m)
        np.stack([D[:, 0, 0], D[:, 0, 1],
                  D[:, 1, 0], D[:, 1, 1]]).astype(dtype),   # (4, m)
    ]
    if block:
        W = _block_major(W, 2)
    else:
        arrays.append((row_select % 2 == 0).astype(dtype)[None, :])
    return {
        "kind": "tris_strain",
        "block": block,
        "gathers": [_onehot(faces[:, k], n_sel, dtype) for k in range(3)],
        "arrays": arrays,
        "WT": _wt(W, dtype),
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
        "WT": _wt(W, dtype),
    }


def pack_tets(kind: str, subset_data: dict, lookup: np.ndarray,
              W: np.ndarray, row_select: np.ndarray | None, dtype) -> dict:
    """tets_strain / tets_deformation_gradient packing: 4 one-hot gathers,
    DmInv as 9 entry rows.  Row form carries the selected projection row
    (0..2) of each element as the indicators r0, r1; block form
    (``row_select`` None) emits all 3 rows, W permuted to row-major
    blocks."""
    el = lookup[np.asarray(subset_data["elements"])]
    n_sel = int(lookup.max()) + 1 if len(lookup) else 0
    D = np.asarray(subset_data["DmInv"])       # (m, 3, 3)
    block = row_select is None
    arrays = [np.stack([D[:, i, j] for i in range(3)
                        for j in range(3)]).astype(dtype)]   # (9, m)
    if block:
        W = _block_major(W, 3)
    else:
        rsel = (row_select % 3).astype(np.int64)
        arrays.append((rsel == 0).astype(dtype)[None, :])     # (1, m)
        arrays.append((rsel == 1).astype(dtype)[None, :])
    out = {
        "kind": kind,
        "block": block,
        "gathers": [_onehot(el[:, k], n_sel, dtype) for k in range(4)],
        "arrays": arrays,
        "WT": _wt(W, dtype),
    }
    if kind == "tets_strain":
        out["smin"] = float(subset_data["sigma_min"])
        out["smax"] = float(subset_data["sigma_max"])
    return out


def pack_verts_bending(subset_data: dict, lookup: np.ndarray,
                       W: np.ndarray, dtype) -> dict:
    """Bending packing: the weighted star Laplacian row of each constraint
    as a dense (m, n_sel) gather matrix (``fused_operands`` keeps it as
    sparse columns)."""
    centers = lookup[np.asarray(subset_data["indices"])]
    nbrs = lookup[np.asarray(subset_data["neighbors"])]
    cots = np.asarray(subset_data["cotans"])
    mask = np.asarray(subset_data["mask"])
    n_sel = int(lookup.max()) + 1 if len(lookup) else 0
    m = len(centers)
    Wb = np.zeros((m, n_sel), dtype=dtype)
    for i in range(m):
        Wb[i, centers[i]] += cots[i, mask[i]].sum()
        for j in np.nonzero(mask[i])[0]:
            Wb[i, nbrs[i, j]] -= cots[i, j]
    return {
        "kind": "verts_bending",
        "prevent_flips": bool(subset_data.get("prevent_bending_flips", True)),
        "gathers": [Wb],
        "arrays": [
            np.asarray(subset_data["rest_curvature"]).astype(dtype)[None, :],
            np.asarray(subset_data["tri_normal"]).T.astype(dtype),  # (3, m)
            np.asarray(subset_data["dot_with_normal"]).astype(
                dtype)[None, :],
        ],
        "WT": _wt(W, dtype),
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
    gptr: torch.Tensor       # (g_total + 1,) int32: Vc column c sums the
    gcol: torch.Tensor       # (nnz,) int32     entries gptr[c]..gptr[c+1]
    gw: torch.Tensor         # (nnz,) float64   (snT_sel column, weight)
    elem_kind: torch.Tensor  # (m_total,) int32
    elem_g: torch.Tensor     # (ELEM_SLOTS, m_total) int32 Vall column per slot
    elem_f: torch.Tensor     # (ELEM_ROWS, m_total) rest data
    segments: tuple          # ((kind, first column, columns, smin, smax), ...)
    UG_allT: torch.Tensor    # (3, r, g_total) U_selT G_allT
    # the sparse columns padded to their longest (the plain version's
    # gather): (kmax, g_total) snT_sel columns and float64 weights, 0 past
    # a column's end
    gpad_col: torch.Tensor
    gpad_w: torch.Tensor
    # the cluster loop's projection order (csrc/iteration_cluster.cuh): the
    # table's columns with each kind's run starting at a multiple of 32
    # threads, so that no warp runs two kinds' emitters; -1 an idle thread
    lane_cols: torch.Tensor

    @property
    def r(self) -> int:
        return self.inv3.shape[1]

    @property
    def g_total(self) -> int:
        return self.C_allT.shape[2]

    @property
    def m_total(self) -> int:
        return self.WT_all.shape[1]


def sparse_columns(G: np.ndarray):
    """The columns of a gather matrix G (n_sel, g) as CSR -> (gptr (g + 1,),
    gcol (nnz,), gw (nnz,) float64): per column its nonzero rows in
    ascending order and their weights."""
    cols, rows = np.nonzero(np.asarray(G).T)
    gptr = np.searchsorted(cols, np.arange(G.shape[1] + 1)).astype(np.int32)
    gw = np.asarray(G, dtype=np.float64)[rows, cols]
    return gptr, rows.astype(np.int32), gw


def _pad_columns(gptr, gcol, gw):
    """The CSR columns padded to (kmax, g): column index 0 and weight 0 past
    a column's end."""
    counts = np.diff(gptr)
    kmax = max(int(counts.max(initial=0)), 1)
    g = len(counts)
    pc = np.zeros((kmax, g), np.int64)
    pw = np.zeros((kmax, g))
    for k in range(kmax):
        has = counts > k
        pc[k, has] = gcol[gptr[:-1][has] + k]
        pw[k, has] = gw[gptr[:-1][has] + k]
    return pc, pw


def _block_rows(name: str, block: bool, arrs: list):
    """The fixed rows of a group's columns -> list over its row blocks of
    {table row: value} (one block in row form): tris ``row_is0``, tets
    (r0, r1), as the JAX emitters read them."""
    if name == "tris_strain":
        if block:
            return [{10: 1.0}, {10: 0.0}]
        return [{10: arrs[3][0]}]
    if name in TET_KINDS:
        if block:
            return [{9: 1.0, 10: 0.0}, {9: 0.0, 10: 1.0}, {9: 0.0, 10: 0.0}]
        return [{9: arrs[1][0], 10: arrs[2][0]}]
    return [{}]


def fused_operands(ops: dict, device, dtype) -> FusedOperands:
    """Cast ``prepare_fused_operands``' arrays (the port's or the JAX
    package's) once to ``dtype`` on ``device`` and build the element
    table and the sparse gather columns the kernel reads.  Raises
    ``NotImplementedError`` for a kind that has no emitter."""
    G = np.asarray(ops["G_allT"], dtype=np.float64)      # (n_sel, g_total)
    gptr, gcol, gw = sparse_columns(G)
    m_total = np.asarray(ops["WT_all"]).shape[1]
    kind = np.zeros(m_total, np.int32)
    eg = np.zeros((ELEM_SLOTS, m_total), np.int32)
    ef = np.zeros((ELEM_ROWS, m_total))
    segments = []
    col = 0
    off = 0
    for (name, cnt, smin, smax, pflips, block), slices in zip(
            ops["layout"], ops["gather_slices"]):
        arrs = [np.asarray(a, dtype=np.float64)
                for a in ops["flat_arrays"][off:off + cnt]]
        off += cnt
        if name not in PORTED_KINDS:
            raise NotImplementedError(f"no emitter for group kind {name}")
        m = slices[0][1]
        rows = _block_rows(name, block, arrs)
        start = col
        for fixed in rows:
            if col + m > m_total:
                raise ValueError(f"layout covers more than the {m_total} "
                                 "rhs columns")
            cols = slice(col, col + m)
            kind[cols] = KIND_CODES[name]
            for s_, (first, length) in enumerate(slices):
                assert length == m
                eg[s_, cols] = first + np.arange(m)
            if name == "tris_strain":
                P0T, P1T, Dm = arrs[:3]
                ef[0:3, cols] = P0T
                ef[3:6, cols] = P1T
                ef[6:10, cols] = Dm
            elif name == "edge_spring":
                ef[0, cols] = arrs[0][0]
            elif name in TET_KINDS:
                ef[0:9, cols] = arrs[0]
            else:   # verts_bending
                rest, tri_n, dot_n = arrs
                ef[0, cols] = rest[0]
                ef[1:4, cols] = tri_n
                ef[4, cols] = dot_n[0]
                ef[5, cols] = float(bool(pflips))
            for row, v in fixed.items():
                ef[row, cols] = v
            if smin is not None:
                ef[11, cols] = smin
                ef[12, cols] = smax
            col += m
        segments.append((name, start, col - start, smin, smax))
    if col != m_total:
        raise ValueError(f"layout covers {col} of {m_total} rhs columns")
    pc, pw = _pad_columns(gptr, gcol, gw)
    lane_cols = warp_runs(segments)

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    return FusedOperands(
        C_allT=t(np.asarray(ops["C_allT"], np.float64)),
        inv3=t(np.asarray(ops["inv3"], np.float64)),
        WT_all=t(np.asarray(ops["WT_all"], np.float64)),
        gptr=t(gptr, torch.int32), gcol=t(gcol, torch.int32),
        gw=t(gw, torch.float64), elem_kind=t(kind, torch.int32),
        elem_g=t(eg, torch.int32), elem_f=t(ef),
        segments=tuple(segments),
        UG_allT=t(np.asarray(ops["UG_allT"], np.float64)),
        gpad_col=t(pc, torch.long), gpad_w=t(pw, torch.float64),
        lane_cols=t(lane_cols, torch.int32))


def warp_runs(segments, warp: int = 32) -> np.ndarray:
    """The table's columns, each segment's run padded to a multiple of
    ``warp`` threads (but the last), -1 in the padding."""
    runs = []
    for i, (_, first, cols, _, _) in enumerate(segments):
        run = np.full(cols if i == len(segments) - 1
                      else -(-cols // warp) * warp, -1, np.int32)
        run[:cols] = first + np.arange(cols)
        runs.append(run)
    return np.concatenate(runs) if runs else np.zeros(0, np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def gather_vc(fo: FusedOperands, x):
    """``x_sel G_allT`` (..., 3, g_total) of x (..., 3, n), n >= n_sel, the
    plain version of the kernels' ``gather_col``: each column the weighted
    sum of its entries in float64, in the kernel's order, rounded to x's
    dtype (a one-hot column: x at its vertex, bit for bit)."""
    x64 = x.double()
    acc = fo.gpad_w[0] * x64[..., fo.gpad_col[0]]
    for k in range(1, fo.gpad_col.shape[0]):
        acc = acc + fo.gpad_w[k] * x64[..., fo.gpad_col[k]]
    return acc.to(x.dtype)


def _row(x, i):
    """Row i of (..., 3, m) values as (..., 1, m)."""
    return x[..., i:i + 1, :]


def _sum_dims(x, y):
    """sum_d x[d] * y[d] for (..., 3, m) rows."""
    return (_row(x, 0) * _row(y, 0) + _row(x, 1) * _row(y, 1)
            + _row(x, 2) * _row(y, 2))


def _tri_p(gathered, arrays, smin, smax):
    """Pre-gathered vertex slices -> one projection row per column, (3, m)
    (pallas_reduced.py ``_tri_p``; a block column is a row-form column with
    a fixed ``row_is0``)."""
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
    length = torch.sqrt(_row(spring, 0) ** 2 + _row(spring, 1) ** 2
                        + _row(spring, 2) ** 2)        # (..., 1, m)
    keep = length > 0
    inv_len = torch.where(keep, 1.0 / torch.clamp(length, min=1e-30),
                          torch.zeros_like(length))
    delta = 0.5 * (length - rest)
    return torch.where(keep, 0.5 * spring - delta * inv_len * spring,
                       torch.zeros_like(spring))


def _tet_p(gathered, arrays, kind, smin, smax):
    """tets_strain / tets_deformation_gradient rows (pallas_reduced.py
    ``_tet_p``): the rows blended as r0 row0 + r1 row1 + r2 row2,
    r2 = 1 - r0 - r1 (a block column's (r0, r1) selects one row exactly)."""
    V1, V2, V3, V4 = gathered
    Dm, r0, r1 = arrays
    ds = [V1 - V4, V2 - V4, V3 - V4]
    D = [Dm[k:k + 1] for k in range(9)]
    F = tuple(_row(ds[0], i) * D[0 + j] + _row(ds[1], i) * D[3 + j]
              + _row(ds[2], i) * D[6 + j]
              for i in range(3) for j in range(3))
    if kind == "tets_strain":
        P9 = tet_strain_fhat(F, smin, smax)
        rows = [P9[0:3], P9[3:6], P9[6:9]]
    else:
        R9 = polar_rotation(F)
        rows = [(R9[0], R9[3], R9[6]), (R9[1], R9[4], R9[7]),
                (R9[2], R9[5], R9[8])]
    r2 = 1.0 - r0 - r1
    return torch.cat([r0 * rows[0][d] + r1 * rows[1][d] + r2 * rows[2][d]
                      for d in range(3)], dim=-2)


def _bending_p(gathered, arrays):
    """verts_bending rows (pallas_reduced.py ``_bending_p``), the flip
    prevention per column."""
    (star,) = gathered
    rest, tri_n, dot_n, pflips = arrays
    norm = torch.sqrt(_row(star, 0) ** 2 + _row(star, 1) ** 2
                      + _row(star, 2) ** 2)
    scale = rest / torch.clamp(norm, min=1e-30)
    corr = torch.where(norm < 1e-10, tri_n * rest, star * scale)
    dots = _sum_dims(tri_n, corr)
    flip = (pflips > 0) & (norm > 1e-5) & (dots * dot_n < 0)
    return torch.where(flip, -corr, corr)


def _projection_rows(fo: FusedOperands, Vall):
    """pT (..., 3, m_total): every column's projection row, read from the
    element table."""
    eg = fo.elem_g.long()
    ef = fo.elem_f
    parts = []
    for name, c0, m, smin, smax in fo.segments:
        cols = slice(c0, c0 + m)

        def slots(n):
            return [Vall[..., eg[s, cols]] for s in range(n)]

        if name == "tris_strain":
            parts.append(_tri_p(slots(3), [ef[0:3, cols], ef[3:6, cols],
                                           ef[6:10, cols], ef[10:11, cols]],
                                smin, smax))
        elif name == "edge_spring":
            parts.append(_spring_p(slots(2), [ef[0:1, cols]]))
        elif name in TET_KINDS:
            parts.append(_tet_p(slots(4), [ef[0:9, cols], ef[9:10, cols],
                                           ef[10:11, cols]], name, smin,
                                smax))
        else:
            parts.append(_bending_p(slots(1), [ef[0:1, cols], ef[1:4, cols],
                                               ef[4:5, cols],
                                               ef[5:6, cols]]))
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
    version of the batched build).  ``Vc = snT_sel G_allT`` is taken by
    the sparse columns (:func:`gather_vc`)."""
    if snT_sel.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    Vc = gather_vc(fo, snT_sel)
    return solve_plain(fo, iterate_plain(fo, Vc, rb_const, num_iterations))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _I, _L) + (_P,) * 11 + (_I,) * 5 + (_P,) + (_I,) * 3 + (_P,)


def _check_cuda_operands(fo: FusedOperands, tensors: dict):
    dev = fo.C_allT.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, operands on {dev}")
        if t.dtype != fo.C_allT.dtype:
            raise TypeError(f"{name} is {t.dtype}, operands are "
                            f"{fo.C_allT.dtype}")


def fused_plan(fo: FusedOperands):
    """The staging plan kernel 1 runs on for these operands."""
    return staging_plan("fused_reduced", fo.r, fo.g_total, fo.m_total)


def fused_args(fo: FusedOperands, snT_sel, rb_const, u,
               num_iterations: int, stream=None):
    """The arguments of csrc/fused_reduced.cu's C entry point (``FUSED_ENTRY``,
    typed by ``_ARGTYPES``) for one launch over the sims of the leading
    axis of snT_sel (..., 3, n_sel) and rb_const (..., 3, r) into u: the
    grid's nb sims (one cluster each), the projection order, the staging
    plan's bits and bytes a block (:func:`fused_plan`).  Checks the shapes
    and raises on what the kernel does not take."""
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
    plan = fused_plan(fo)
    p = _build.ptr
    return (p(snT_sel), int(snT_sel.stride(-2)), sim_sn, p(rb_const),
            p(fo.C_allT), p(fo.inv3), p(fo.WT_all), p(fo.gptr), p(fo.gcol),
            p(fo.gw), p(fo.elem_kind), p(fo.elem_g), p(fo.elem_f), p(u), r, g,
            m, int(num_iterations), nb, p(fo.lane_cols),
            fo.lane_cols.numel(), plan.bits, plan.smem_bytes, stream)


def _launch_fused(fo: FusedOperands, snT_sel, rb_const, num_iterations: int):
    """One launch of csrc/fused_reduced.cu over the sims of the leading
    axis of snT_sel (..., 3, n_sel) and rb_const (..., 3, r): a grid of one
    cluster of three blocks per sim, on the staging plan of
    :func:`fused_plan` -> u, counted in ``device.launches``.  A launch the
    card refuses (a cluster that cannot be placed with the plan's shared
    memory, a plan whose bytes differ from the kernel's carving) raises."""
    if snT_sel.device.type != "cuda":
        raise ValueError(f"unsupported device {snT_sel.device}")
    u = torch.empty(rb_const.shape, dtype=rb_const.dtype,
                    device=rb_const.device)
    args = fused_args(fo, snT_sel, rb_const, u, num_iterations,
                      _build.stream_of(rb_const.device))
    fn = _build.function("fused_reduced", "fused_reduced_iterations_f32",
                         _ARGTYPES)
    _build.check("fused_reduced", fn(*args), "fused_reduced_iterations")
    count("device.launches")
    return u


def fused_reduced_iterations(fo: FusedOperands, snT_sel, rb_const,
                             num_iterations: int):
    """u (3, r) after ``num_iterations`` of the loop.  A CPU tensor runs the
    plain version; a CUDA tensor launches ``csrc/fused_reduced.cu`` (one
    cluster of three blocks) on the current stream, or raises."""
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
    of B clusters, one sim each, or raise."""
    if snT_sel.dim() != 3:
        raise ValueError("snT_sel must be (B, 3, n_sel)")
    if snT_sel.device.type == "cpu":
        return fused_reduced_iterations_plain(fo, snT_sel, rb_const,
                                              num_iterations)
    u = _launch_fused(fo, snT_sel, rb_const, num_iterations)
    fused_reduced_iterations_batched.launches += 1
    return u


fused_reduced_iterations_batched.launches = 0
register_launches(fused_reduced_iterations, fused_reduced_iterations_batched)
