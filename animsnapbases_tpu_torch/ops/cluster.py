"""The staging plan of the cluster loop (``csrc/iteration_cluster.cuh``).

Kernels 1 and 5 run their iteration loop on one cluster of three thread
blocks per sim, block d owning dimension d.  Which of a block's
per-dimension operands live in its shared memory is decided here, on the
host, from the widths (r, g, m, n_sel), the kernel, the build's
``fold_vc`` and the element size, in this order:

1. the per-iteration operands ``C_d`` (r, g) and ``WT_d`` (m, r);
2. then ``inv3_d`` (r, r);
3. then kernel 5's per-step ``M_utac_d`` (r, r) and ``UG_d`` (r, g) (or
   ``U_selT_d`` (r, n_sel) without ``fold_vc``).

Each stages when it fits beside the block's buffers and what staged
before it, within the 232,448 bytes a block can use; what does not fit is
read from L2.  The wrapper passes the plan's bits and bytes to the launch
(the kernel carves its shared memory by the same rules and refuses a plan
whose bytes differ).  :func:`staging_plan` mirrors ``loop_layout`` and
``chunk_layout`` of the sources: every piece padded to 4 elements, rows of
staged operands to a multiple of 4.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

from animsnapbases_tpu_torch.ops import _build

SMEM_MAX = 232_448   # bytes a block can use on the H100 (227 KB)
CLUSTER = 3          # blocks a cluster: one per dimension
THREADS = 256        # threads a block
# the plan's bits (csrc/iteration_cluster.cuh STAGE_*)
STAGE_BITS = {"C": 1, "WT": 2, "inv3": 4, "M_utac": 8, "UG": 16,
              "U_selT": 16}
KERNELS = ("fused_reduced", "affine_chunked")


def pad4(n: int) -> int:
    return (n + 3) // 4 * 4


@dataclass(frozen=True)
class StagingPlan:
    """What one block of the cluster keeps in shared memory."""
    kernel: str
    staged: tuple          # operand names, in staging order
    from_l2: tuple         # the rest
    smem_bytes: int        # a block's dynamic shared memory
    bits: int              # STAGE_BITS of ``staged``
    operand_bytes: tuple   # ((name, bytes a block), ...) of every operand

    def as_dict(self) -> dict:
        return {"kernel": self.kernel, "staged": list(self.staged),
                "from_l2": list(self.from_l2),
                "smem_bytes": self.smem_bytes, "bits": self.bits,
                "operand_bytes": dict(self.operand_bytes),
                "cluster": [CLUSTER, 1, 1], "threads": THREADS}


def buffer_elems(kernel: str, r: int, g: int, m: int, n_sel: int = 0,
                 fold_vc: bool = True) -> int:
    """Elements of a block's own buffers: the loop's (rbc, rb, Vc, two
    buffers of Vall's three rows, pT, 16 words) and kernel 5's (the
    coefficient rows, nine r-long rows, b0s/b1s/fas or the selected
    prefix, reductions, the bound's minima and maxima)."""
    n = 2 * pad4(r) + 7 * pad4(g) + pad4(m) + 16
    if kernel == "affine_chunked":
        n += 16 + 9 * pad4(r) + (3 * pad4(g) if fold_vc else pad4(n_sel))
        n += 16 + 8
    return n


@lru_cache(maxsize=None)
def staging_plan(kernel: str, r: int, g: int, m: int, n_sel: int = 0,
                 fold_vc: bool = True, itemsize: int = 4) -> StagingPlan:
    """The staging plan of ``kernel`` ("fused_reduced" or
    "affine_chunked") at these widths.  Raises ValueError when the block's
    own buffers do not fit."""
    if kernel not in KERNELS:
        raise ValueError(f"no cluster loop in {kernel}")
    if itemsize != 4:
        raise ValueError("the cluster loop stages 4-byte elements")
    operands = [("C", r * pad4(g)), ("WT", m * pad4(r)),
                ("inv3", r * pad4(r))]
    if kernel == "affine_chunked":
        operands.append(("M_utac", r * pad4(r)))
        operands.append(("UG", r * pad4(g)) if fold_vc
                        else ("U_selT", r * pad4(n_sel)))
    total = itemsize * buffer_elems(kernel, r, g, m, n_sel, fold_vc)
    if total > SMEM_MAX:
        raise ValueError(f"{kernel}: the loop's buffers take {total} B, "
                         f"more than a block's {SMEM_MAX}")
    staged, rest = [], []
    for name, elems in operands:
        nbytes = itemsize * elems
        if total + nbytes <= SMEM_MAX:
            staged.append(name)
            total += nbytes
        else:
            rest.append(name)
    return StagingPlan(
        kernel=kernel, staged=tuple(staged), from_l2=tuple(rest),
        smem_bytes=total, bits=sum(STAGE_BITS[n] for n in staged),
        operand_bytes=tuple((n, itemsize * e) for n, e in operands))


def resident_clusters(library: str, plan: StagingPlan) -> int:
    """How many clusters of the kernel of ``csrc/<library>.cu`` (kernel
    5's default build) the card holds at
    once with the plan's shared memory a block
    (cudaOccupancyMaxActiveClusters; -1 when it holds none)."""
    fn = _build.function(library, f"{library}_max_clusters", (ctypes.c_int,))
    return int(fn(plan.smem_bytes))
