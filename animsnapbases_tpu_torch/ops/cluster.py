"""The staging plan of the cluster loop (``csrc/iteration_cluster.cuh``).

Every kernel runs its iteration loop on one cluster of three thread blocks
per sim, block d owning dimension d: kernel 1 ("fused_reduced"), kernel 2's
iteration launch ("resident"), the cluster launches of kernels 3 and 4
("affine": ``free_step``, ``contact_solve``, ``mode_solve``) and kernel 5
("affine_chunked").  Which of a block's per-dimension operands live in its
shared memory is decided here, on the host, from the widths (r, g, m,
n_sel), the kernel, the build's ``fold_vc`` and the element size, in this
order:

1. the per-iteration operands ``C_d`` (r, g) and ``WT_d`` (m, r);
2. then ``inv3_d`` (r, r);
3. then, for kernels 3-5, the per-step ``M_utac_d`` (r, r), and kernel 5's
   ``UG_d`` (r, g) or, for kernels 3, 4 and kernel 5 without ``fold_vc``,
   ``U_selT_d`` (r, n_sel).

Each stages when it fits beside the block's buffers and what staged
before it, within the 232,448 bytes a block can use; what does not fit is
read from L2.  The wrapper passes the plan's bits and bytes to the launch
(the kernel carves its shared memory by the same rules and refuses a plan
whose bytes differ).  :func:`staging_plan` mirrors ``loop_layout``,
``affine_layout`` and ``chunk_layout`` of the sources: every piece padded
to 4 elements, rows of staged operands to a multiple of 4.

A batched launch (one cluster a sim) may hold more sims than the card
keeps clusters resident at once; the rest run in further waves.
:func:`launch_plan` then stages less where that needs fewer waves (a block
of the full plan may leave room for one on an SM, a smaller one for two).
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
KERNELS = ("fused_reduced", "resident", "affine", "affine_chunked")


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
    buffers of Vall's three rows, pT, 16 words); kernels 3 and 4's (the
    coefficient rows ap, av, asn, avd, the r-long rows wp, wv, wsn, u and
    contact mode's s, the selected prefix); kernel 5's (the coefficient
    rows, eleven r-long rows, the interval bound's two among them,
    b0s/b1s/fas or the selected prefix, reductions, the bound's minima and
    maxima)."""
    n = 2 * pad4(r) + 7 * pad4(g) + pad4(m) + 16
    if kernel == "affine":
        n += 16 + 5 * pad4(r) + pad4(n_sel)
    if kernel == "affine_chunked":
        n += 16 + 11 * pad4(r) + (3 * pad4(g) if fold_vc else pad4(n_sel))
        n += 16 + 8
    return n


@lru_cache(maxsize=None)
def staging_plan(kernel: str, r: int, g: int, m: int, n_sel: int = 0,
                 fold_vc: bool = True, itemsize: int = 4,
                 most: int | None = None) -> StagingPlan:
    """The staging plan of ``kernel`` (one of ``KERNELS``) at these widths;
    with ``most``, only the first ``most`` operands of the staging order
    may stage.  Raises ValueError when the block's own buffers do not
    fit."""
    if kernel not in KERNELS:
        raise ValueError(f"no cluster loop in {kernel}")
    if itemsize != 4:
        raise ValueError("the cluster loop stages 4-byte elements")
    ops = [("C", r * pad4(g)), ("WT", m * pad4(r)), ("inv3", r * pad4(r))]
    if kernel in ("affine", "affine_chunked"):
        ops.append(("M_utac", r * pad4(r)))
        ops.append(("UG", r * pad4(g)) if kernel == "affine_chunked"
                   and fold_vc else ("U_selT", r * pad4(n_sel)))
    total = itemsize * buffer_elems(kernel, r, g, m, n_sel, fold_vc)
    if total > SMEM_MAX:
        raise ValueError(f"{kernel}: the loop's buffers take {total} B, "
                         f"more than a block's {SMEM_MAX}")
    staged, rest = [], []
    for i, (name, elems) in enumerate(ops):
        nbytes = itemsize * elems
        if (most is None or i < most) and total + nbytes <= SMEM_MAX:
            staged.append(name)
            total += nbytes
        else:
            rest.append(name)
    return StagingPlan(
        kernel=kernel, staged=tuple(staged), from_l2=tuple(rest),
        smem_bytes=total, bits=sum(STAGE_BITS[n] for n in staged),
        operand_bytes=tuple((n, itemsize * e) for n, e in ops))


def waves(nb: int, clusters: int) -> int:
    """Waves of clusters that nb sims (one cluster each) take when the card
    keeps ``clusters`` resident at once."""
    return -(-nb // clusters)


def launch_plan(kernel: str, library: str, nb: int, r: int, g: int, m: int,
                n_sel: int = 0, fold_vc: bool = True,
                clusters=None) -> StagingPlan:
    """The plan a launch of ``nb`` sims of ``kernel`` (built in
    ``csrc/<library>.cu``) runs on.  One sim: the full plan.  A batch: of
    the plans that stage the first k operands of the staging order (k from
    all down to none), the one that needs the fewest waves of clusters on
    the card (``clusters(library, plan)``, :func:`resident_clusters` by
    default), and of those the one that stages the most.  Raises when the
    card holds no cluster of any of them: no fallback to another loop or a
    plain version."""
    full = staging_plan(kernel, r, g, m, n_sel, fold_vc)
    if nb == 1:
        return full
    count = clusters or resident_clusters
    best, fewest = None, None
    for k in range(len(full.operand_bytes), -1, -1):
        plan = staging_plan(kernel, r, g, m, n_sel, fold_vc, most=k)
        n = count(library, plan)
        if n >= 1 and (fewest is None or waves(nb, n) < fewest):
            best, fewest = plan, waves(nb, n)
    if best is None:
        raise RuntimeError(f"{library}: the card holds no cluster of "
                           f"{kernel} on any staging plan")
    return best


@lru_cache(maxsize=None)
def _max_clusters(library: str, smem_bytes: int) -> int:
    fn = _build.function(library, f"{library}_max_clusters", (ctypes.c_int,))
    return int(fn(smem_bytes))


def resident_clusters(library: str, plan: StagingPlan) -> int:
    """How many clusters of the cluster launches of ``csrc/<library>.cu``
    (kernel 5's default build; every cluster launch of ``affine.cu``, the
    fewest) the card holds at once with the plan's shared memory a block
    (cudaOccupancyMaxActiveClusters; -1 when it holds none)."""
    return _max_clusters(library, plan.smem_bytes)
