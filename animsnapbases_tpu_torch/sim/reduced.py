"""Reduced projective-dynamics solver: the serving path.

Counterpart of ``animsnapbases_tpu/sim/reduced.py`` (the five group kinds
``tris_strain``, ``edge_spring``, ``tets_strain``,
``tets_deformation_gradient`` and ``verts_bending``, in DEIM row form or in
block form):

    DeformableModel -> AnimSnapBasesSolver(args).set_model(model)
        -> prepare(args) -> step() / run_steps()

It reads the same product ``.npz`` bases as the JAX package.  Host-side
preparation stays numpy/scipy in float64 (the global matrix, ``inv(Ar)``,
``U^T A_c``, the DEIM ``W`` solves, and the ``C_allT`` precomposition) and
is cast once to the working dtype on the solver's device.

The fully-reduced configuration (every constraint group hyper-reduced,
positions reduced to r modes per dim) serves on the kernels below.  The
others serve on plain torch on the solver's device, in
``device.PIPELINE_DTYPE`` (float64) whatever the working dtype, as the
full-order ``Solver`` does (the global matrix carries the 1e10 masses of
pinned vertices), each iteration's local stage made of the full groups'
projections (``sim/solver.py`` ``make_local_stage``) and the reduced
groups' ``W p`` terms (the JAX solver's ``sim/reduced.py:1063-1231``):

* positions reduced with some groups full (or none reduced): ``u =
  Ar^-1 (-U^T A_c s_n + U^T b_full + sum W p)``, ``q = s_n + U u``;
* positions full, 3N <= ``DENSE_LIMIT``: a dense Cholesky factor of the
  global matrix on the device (``cholesky_solve``, not an inverse);
* positions full above it: scipy's sparse LU on the host, b and q crossing
  once per iteration (``step()`` and ``run_steps`` step by step there).

With ``set_store_p(True)`` and a full group, ``step()`` takes that host
path and records the full groups' last-iteration projections per frame
(``<group>_p.npz``, flushed at ``max_p_snapshots_num``), as the JAX
solver's host path does; with positions reduced that raises, as there.

``step()`` runs one step with the iteration loop on kernel 1
(``ops/fused_reduced.py``).  ``run_steps()`` serves on two tiers, as the
JAX solver does (``sim/reduced.py:678-771``, ``:2764-3112``):

* tier 1, contact-free stepping that stops before the first step the floor
  would clamp: the chunked affine kernel 5 (``ops/affine_chunked.py``), or
  with ``resident_chunked_tier1 = False`` the in-kernel early-exit affine
  kernel 4 (``ops/affine.py``);
* the contact tier, which serves the rest of the window: the affine kernel
  3 (``ops/affine.py``), in its contact-mode build (the default, as the JAX
  solver's up to 32,768 vertices) or, with ``resident_contact_mode =
  False``, its lean build, or kernel 2 (``ops/resident.py``, the
  "standard" resident kernel) for models of ``CHUNKED_TIER1_MIN_VERTS``
  vertices and more.  With contact mode on and ``resident_chunked_tier1 =
  False`` there is no tier 1, as in the JAX solver
  (``sim/reduced.py:791``): the contact-mode kernel 3 serves the whole
  window.

The vertex permutation that makes the selected union a prefix is applied
at entry and exit; every kernel runs on the permuted layout.

Positional targets enter every kernel as the target term ``U^T S^T
targets`` (3, r) per step.  Animated targets (``user_defined`` frame
shifts, the poke scenes) make it a schedule: ``prepare()`` builds the
model's whole (T, 3, r) schedule on the host in float64 (a static term plus
one rank-1 term per animated constraint, ``_rb_window_host``), casts it
once and keeps it on the device; a call that starts at frame f hands the
kernels its rows from f on, and step i of the call reads row
min(f + i, T - 1).  Once every shift has ended a call is static (one row).
``run_steps(record=True)`` steps on kernel 1, one schedule row per step,
into a (num_steps, 3, N) buffer on the device that crosses to the host
once.

Self-collision (``enable_self_collision``, as in the JAX package):
False runs no pass; True runs the host resolvers of ``sim/collisions.py``
after each ``step()``, and ``run_steps`` steps through ``step()``;
``"device"`` is captured at ``prepare()`` (``_collision_mode``), and every
step core then applies the masked pass of ``sim/collisions_device.py`` to
q before v = (q - P)/dt: kernel 1's step (on the permuted layout, the
faces remapped), the "mixed" and "dense" steps after their iteration loop,
the host path after its LU.  ``"device"`` set after ``prepare()`` is
applied out of band by ``step()``, and ``run_steps`` then steps through
``step()``.  With the pass captured, ``run_steps`` of a fully reduced
configuration serves on the proximity-gated tier
(:meth:`AnimSnapBasesSolver._run_steps_self_collision`, the JAX
``sim/reduced.py:2508-2762``): the pass is the identity while every vertex
is at least ``collisions_device.MIN_DIST`` from its candidate triangles, so
windows certified clear run on tier 1 without it, and proximity windows
of ``self_collision_contact_window`` steps run on kernel 1 with the pass.
``self_collision_resident = False`` builds no tiers, and ``run_steps``
steps on kernel 1 with the pass.

Ensemble serving, B independent sims of one prepared model on one card
(``sim/reduced.py:1369-1872`` of the JAX package):

* ``make_batched_run()`` serves a window of steps for the whole batch, on
  the model's own target schedule from a serving frame or on a timeline
  ``targets_seq`` shared by the sims (T, e, 3) or per sim (B, T, e, 3):
  below ``CHUNKED_TIER1_MIN_VERTS`` vertices on the batched
  affine kernel 3 (contact mode: a mode per sim; lean: a contact branch
  per sim); at or above it on the
  batched kernel 5, whose whole-batch exit hands a window of steps to the
  batched kernel 2 before stepping returns to kernel 5 (the JAX package's
  vmapped per-step window).  ``_last_batched_path`` records
  ``batched-resident``, ``batched-chunked`` or
  ``batched-chunked+perstep[{w}w]``.  One sim (B = 1) serves on the solo
  kernels.
* ``make_batched_step()`` runs one step for the whole batch, its iteration
  loop on the batched kernel 1, with per-call static ``targets``; with the
  device pass captured it applies the pass to each sim.
* A configuration that is not fully reduced serves both runners on a
  batched :class:`_FullSpace` step in float64 on the card ("mixed" and
  "dense": the local stage of all the sims in one pass, the dense factor
  solved with a right-hand side per sim), ``_last_batched_path``
  ``batched-full``.  The host LU ("host") raises ``RuntimeError``, as the
  JAX package does without a jitted step.

The batched layout on the device is sim-major, (B, 3, N) with sim b's
permuted (3, N) state contiguous (the JAX package keeps dim-major (3B, N)
rows d*B + b): ``_pack`` and ``_unpack`` move (B, N, 3) host arrays across.
There is no fallback: a kernel that fails to build or launch raises.

``make_batched_run`` raises ``RuntimeError`` under any self-collision, and
so does ``make_batched_step`` unless the device pass was captured (the JAX
vmapped step skips an uncaptured pass silently; ROADMAP Queue C).

Over a mesh (``mesh=``, a ``torch.distributed`` ``DeviceMesh``; JAX
``_run_batched_resident_sharded`` and
``_run_batched_resident_chunked_sharded``) every rank of ``batch_axis``
calls the runner with the whole batch, serves its block of B / n sims on
its own card's batched kernels, each sim's schedule split with it, and
the blocks are gathered on every rank (one ``all_reduce`` of the
zero-padded (B, 3, N) state a call, ``parallel/collectives.py``): no
collective in the kernels' loop.  The resident route's sims are those of
one card bit for bit.  On the large-model route the ranks keep lockstep at
every whole-batch exit: each serves kernel 5 for the remaining steps, one
``all_reduce`` agrees on the least k, a rank that served more runs again
for that k (kernel 5 is deterministic), and the windows on kernel 2 run
on every rank at once.  ``_last_batched_path`` is
``batched-resident-sharded[{n}x{B/n}]``,
``batched-chunked-sharded[{n}x{B/n}]`` (with ``+perstep[{w}w]``) or
``batched-full-sharded[{n}x{B/n}]`` after a run, ``batched-step`` or
``batched-full`` after a ``make_batched_step`` call (``-sharded[{n}x{B/n}]``
over a mesh); B must be a multiple of n.

Kernel 5's build options follow the JAX solver's switches
(``resident_floor_bound_skip``, ``resident_floor_exact`` and
``resident_chunked_opts``, :meth:`AnimSnapBasesSolver._chunk_options`);
``resident_floor_exact = None`` resolves from the port's own H100 readings
(``CHUNKED_EXACT_FREE_MIN_VERTS``), not from the JAX package's TPU gate.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from animsnapbases_tpu_torch.device import (
    PIPELINE_DTYPE,
    resolve_device,
    storage_dtype,
    working_dtype,
)
from animsnapbases_tpu_torch.ops.affine import (
    affine_operands,
    resident_affine,
    resident_affine_batched,
    resident_affine_contact,
    resident_affine_contact_batched,
    resident_affine_exit,
)
from animsnapbases_tpu_torch.ops.affine_chunked import (
    ChunkOptions,
    affine_chunked,
    affine_chunked_batched,
)
from animsnapbases_tpu_torch.ops.fused_reduced import (
    TET_KINDS,
    fused_operands,
    fused_reduced_iterations,
    fused_reduced_iterations_batched,
    pack_edge_spring,
    pack_tets,
    pack_tris_strain,
    pack_verts_bending,
    prepare_fused_operands,
)
from animsnapbases_tpu_torch.ops.resident import (
    force_term,
    lift,
    predict,
    rb_at,
    rb_from,
    resident_multistep,
    resident_multistep_batched,
    resident_operands,
    step_once,
)
from animsnapbases_tpu_torch.sim import collisions, projections
from animsnapbases_tpu_torch.sim.collisions_device import (
    MIN_DIST,
    make_collide,
    min_clearance_device,
    min_clearance_lower_bound_device,
)
from animsnapbases_tpu_torch.sim.projections import VERTEX_KEYS
from animsnapbases_tpu_torch.sim.solver import (
    Solver,
    batch_data,
    build_global_matrix,
    device_data,
    make_local_stage,
    positional_targets_timeline,
    unflatten,
)
from animsnapbases_tpu_torch.utils.profiling import (
    annotate,
    count,
    count_bytes,
)

GROUP_ARG_NAMES = {
    "verts_bending": ("vert_bending_reduced", "vert_bending_num_components"),
    "edge_spring": ("edge_spring_reduced", "edge_spring_num_components"),
    "tris_strain": ("tri_strain_reduced", "tri_strain_num_components"),
    "tets_strain": ("tet_strain_reduced", "tet_strain_num_components"),
    "tets_deformation_gradient": ("tet_deformation_reduced",
                                  "tet_deformation_num_components"),
}



def _subset_group_data(g, alphas: np.ndarray) -> dict:
    """Slice a group's SoA rest data down to the selected elements."""
    d = g.data
    name = g.name
    sub = {}
    if name == "verts_bending":
        for k in ("indices", "neighbors", "cotans", "mask", "rest_curvature",
                  "tri_normal", "dot_with_normal", "wi_eff"):
            sub[k] = d[k][alphas]
        sub["prevent_bending_flips"] = d.get("prevent_bending_flips", True)
    elif name == "edge_spring":
        sub["edges"] = d["edges"][alphas]
        sub["rest_length"] = d["rest_length"][alphas]
    elif name == "tris_strain":
        for k in ("faces", "P", "DmInv"):
            sub[k] = d[k][alphas]
        sub["sigma_min"], sub["sigma_max"] = d["sigma_min"], d["sigma_max"]
    elif name in ("tets_strain", "tets_deformation_gradient"):
        for k in ("elements", "DmInv"):
            sub[k] = d[k][alphas]
        if name == "tets_strain":
            sub["sigma_min"], sub["sigma_max"] = d["sigma_min"], d["sigma_max"]
    else:
        raise ValueError(f"cannot subset group {name}")
    return sub


class ReducedGroup:
    """Runtime data of one hyper-reduced constraint group."""

    def __init__(self, name, W, subset_data, row_select, p, num_selected):
        self.name = name
        self.W = W                    # (3, out_dim, n_pt) stacked per dim
        self.subset_data = subset_data
        self.row_select = row_select  # None (block form) or (m,) row gather
        self.p = p
        self.num_selected = num_selected


def prepare_reduced_group(g, reduction_type: str, num_components: int,
                          npz_path: str, n_verts: int,
                          U: np.ndarray | None = None,
                          tikhonov: bool = True,
                          oversample: float = 1.0):
    """Load a basis .npz and build the precomposed rhs matrices
    ``W_d = (S^T V)_d (AtA_d + la_d I)^{-1} (PtV^T)_d`` (Ut-composed under
    position reduction).  Returns (ReducedGroup, alphas, Pt).

    ``oversample`` > 1 keeps ``num_components`` basis modes but takes the
    interpolation rows selected for ``oversample * num_components`` modes
    (least-squares DEIM, which keeps the iteration contractive)."""
    data = np.load(npz_path)
    row_dim = 1 if reduction_type in ("deim_pod", "deim_pod_vectorized") \
        else g.p
    Vj = data["components"].swapaxes(0, 1)[:, :num_components * row_dim, :]
    ranges = data["interpol_alpha_ranges"]
    range_idx = min(int(round(num_components * oversample)),
                    len(ranges)) - 1
    alpha_range = int(ranges[range_idx])
    alphas = data["interpol_alphas"][:alpha_range].astype(np.int64)

    if reduction_type in ("deim_pod", "deim_pod_vectorized"):
        Pt = data["Pt"][:alpha_range].astype(np.int64)
    else:
        # block form: all row_dim rows of each selected element, interleaved
        Pt = (alphas[:, None] * row_dim
              + np.arange(row_dim)[None, :]).reshape(-1)

    ST = g.assembly_scipy(n_verts)                     # (N, e*p)
    proj = np.stack([ST @ Vj[:, :, d] for d in range(3)], axis=2)  # (N, m', 3)
    PtV = Vj[Pt]                                       # (n_pt, m', 3)
    AtA = np.einsum("nai,ami->nmi", PtV.swapaxes(0, 1), PtV)
    la = (1e-8 * np.trace(AtA) / AtA.shape[0]) if tikhonov else np.zeros(3)
    # a dim whose projections are all ~zero (a perfectly flat cloth) has
    # trace ~0: floor the regularizer with the healthiest dim's scale
    la = la + 1e-12 * (np.max(np.trace(AtA)) / AtA.shape[0] + 1e-30)

    W = []
    for d in range(3):
        A_d = AtA[:, :, d] + la[d] * np.eye(AtA.shape[0])
        inv_pt = np.linalg.solve(A_d, PtV[:, :, d].T)   # (m', n_pt)
        base = proj[:, :, d] @ inv_pt                   # (N, n_pt)
        if U is not None:
            base = U[:, :, d].T @ base                  # (r, n_pt)
        W.append(base)
    W = np.stack(W, axis=0)

    subset = _subset_group_data(g, alphas)
    if reduction_type in ("deim_pod", "deim_pod_vectorized"):
        # evaluate one row (Pt % p) of each selected element's projection
        m = len(alphas)
        row_select = np.arange(m) * g.p + (Pt % g.p)
    else:
        row_select = None
    return ReducedGroup(g.name, W, subset, row_select, g.p, len(alphas)), \
        alphas, Pt


class _GroupView:
    """The model as ``make_local_stage`` sees it, with a subset of its
    groups."""

    def __init__(self, model, groups):
        self.groups = groups
        self.n_verts = model.n_verts


class _FullSpace:
    """The plain torch step of a configuration that is not fully reduced
    (see the module docstring), on the solver's device in float64: ``mode``
    is "mixed" (positions reduced), "dense" or "host" (positions full).
    ``collide`` is the device pass captured at prepare (None: no pass).
    The device modes also step B sims at once on (B, N, 3) state
    (:meth:`stage`)."""

    def __init__(self, solver, collide=None):
        model = solver.model
        dev, dt64 = solver.device, PIPELINE_DTYPE
        full = {name: g for name, g in model.groups.items()
                if name not in solver._reduced_groups}
        # the full constraint groups, whose projections a step can record
        self.recorded = [name for name in full if name != "positional"]
        self.view = _GroupView(model, full)
        self.local_full = make_local_stage(self.view, dev, dt64)
        self.reduced = [
            (name, device_data(rg.subset_data, dev, dt64),
             torch.as_tensor(rg.W, dtype=dt64, device=dev),
             None if rg.row_select is None
             else torch.as_tensor(rg.row_select, device=dev))
            for name, rg in solver._reduced_groups.items()]
        self.n = model.n_verts
        self.collide = collide
        self._stages = {}            # B -> the batched stage
        self.mass = torch.as_tensor(model.mass, dtype=dt64, device=dev)
        self.dt, self.eta = solver.dt, solver.eta
        self.floor = model.floor_collision
        self.floor_h = model.floor_height
        if solver.reduced_position:
            self.mode = "mixed"
            self.U = torch.as_tensor(solver.U, dtype=dt64, device=dev)
            self.inv3 = torch.as_tensor(solver._inv_np, dtype=dt64,
                                        device=dev)
            self.ut_ac = torch.as_tensor(solver._ut_ac_np, dtype=dt64,
                                         device=dev)
        else:
            self.mode = "dense" if solver._chol_full is not None else "host"
            self.chol = solver._chol_full
            self.lu = solver._solve

    def tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=PIPELINE_DTYPE,
                               device=self.mass.device)

    def stage(self, B):
        """(local stage of the full groups, reduced groups) of one sim
        (B None) or of B sims in one pass: their data stacked along the
        vertex axis (``sim/solver.py`` ``batch_data``)."""
        if B is None:
            return self.local_full, self.reduced
        if B not in self._stages:
            dev = self.mass.device
            self._stages[B] = (
                make_local_stage(self.view, dev, PIPELINE_DTYPE, batch=B),
                [(name, batch_data(name, data, B, self.n), W, rs)
                 for name, data, W, rs in self.reduced])
        return self._stages[B]

    @staticmethod
    def reduced_terms(q, reduced):
        """The reduced groups' ``W p`` terms, (..., r, 3) each (positions
        reduced) or (..., N, 3), of q (N, 3) or of B sims (B, N, 3) with
        their stacked data (:meth:`stage`)."""
        terms = []
        lead = q.shape[:-2]
        for name, data, W, rs in reduced:
            p = projections.PROJECTION_KERNELS[name](q.reshape(-1, 3), data)
            p = p.reshape(lead + (-1, 3))
            if rs is not None:
                p = p[..., rs, :]
            terms.append(torch.einsum("dop,...pd->...od", W, p))
        return terms

    def local_terms(self, q, targets, B=None):
        """The full-space rhs of the constraints, and the full groups'
        stacked projections."""
        local_full, reduced = self.stage(B)
        b, stacked = local_full(q, targets)
        for term in self.reduced_terms(q, reduced):
            b = b + term
        return b, stacked

    def solve(self, b):
        """The global solve of the positions-full modes, of one sim's b (N,
        3) or, "dense", of B sims' (B, N, 3) in one ``cholesky_solve`` with
        a right-hand side per sim."""
        if self.mode == "dense":
            if b.dim() == 3:
                rhs = b.reshape(b.shape[0], -1).T
                return torch.cholesky_solve(rhs, self.chol).T.reshape(
                    b.shape)
            return torch.cholesky_solve(b.reshape(-1, 1),
                                        self.chol).reshape(-1, 3)
        q = self.lu(b.cpu().numpy().reshape(-1))
        return self.tensor(unflatten(q))

    def predict(self, P, V, fext):
        """The predictor s_n, clamped to the floor."""
        dt = self.dt
        sn = P + (dt * self.eta) * V + (dt * dt) * (fext / self.mass[:, None])
        if self.floor:
            sn = sn.clone()
            sn[..., 1] = torch.clamp(sn[..., 1], min=self.floor_h)
        return sn

    def apply_pass(self, q):
        """The captured device pass of q (N, 3), or of each sim of (B, N,
        3)."""
        if self.collide is None:
            return q
        if q.dim() == 2:
            return self.collide(q)
        return torch.stack([self.collide(x) for x in q])

    def step(self, P, V, fext, targets, num_iterations):
        """One step of the device modes ("mixed", "dense") -> (q, v), of
        one sim (N, 3) or of B sims (B, N, 3) with the targets (e, 3)
        shared or (B, e, 3) per sim; the captured pass applied to q before
        v."""
        B = P.shape[0] if P.dim() == 3 else None
        local_full, reduced = self.stage(B)
        sn = self.predict(P, V, fext)
        q = sn
        if self.mode == "mixed":
            rb_base = -torch.einsum("drn,...nd->...rd", self.ut_ac, sn)
            for _ in range(num_iterations):
                b_full, _ = local_full(q, targets)
                rb = rb_base + torch.einsum("nrd,...nd->...rd", self.U,
                                            b_full)
                for term in self.reduced_terms(q, reduced):
                    rb = rb + term
                u = torch.einsum("drs,...sd->...rd", self.inv3, rb)
                q = sn + torch.einsum("nrd,...rd->...nd", self.U, u)
        else:
            masses_term = (self.mass / (self.dt * self.dt))[:, None] * sn
            for _ in range(num_iterations):
                b, _ = self.local_terms(q, targets, B)
                q = self.solve(b + masses_term)
        q = self.apply_pass(q)
        return q, (q - P) / self.dt


class AnimSnapBasesSolver:
    """Reduced solver built from sim args, serving on the port's kernels.

    ``device`` defaults to ``"cuda"`` and raises without a card; tests pass
    ``device="cpu"`` (plain versions, float64 by default).  ``dtype`` is the
    working dtype (float32 on the card, float64 on the CPU by default);
    ``matmul_dtype`` the storage dtype of the two (3, r, N) matrices.

    ``run_steps``' tiers follow the JAX solver's instance switches, read at
    ``prepare``: ``resident_chunked_tier1`` (default True: kernel 5 is tier
    1; False: kernel 4, or no tier 1 in contact mode),
    ``resident_contact_mode`` (default None: kernel 3's contact-mode build;
    False: its lean build, :meth:`_build_tiers`) and
    ``resident_rebase_every`` (default 1024 steps for kernel 5's chunks and
    256 for the in-kernel rebase of kernels 3 and 4: windows of float32
    coefficient drift), and kernel 5's build: ``resident_floor_bound_skip``,
    ``resident_floor_exact`` and ``resident_chunked_opts``
    (:meth:`_chunk_options`)."""

    DENSE_LIMIT = 2400   # max 3N for the dense Cholesky of full positions
    # models of this many vertices or more take kernel 2 as the contact
    # tier instead of kernel 3: the JAX package's value, which keeps its
    # tiers.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, "Findings"),
    # at the bench scene's 14,400 vertices kernel 2 runs a contact step in
    # ~111 us against kernel 3's ~141 us, and a free step in ~110 us against
    # ~114-117 us: there kernel 2 would be the faster contact tier too.
    CHUNKED_TIER1_MIN_VERTS = 64000
    # models of this many vertices or more take kernel 5's exact-free build
    # when resident_floor_exact is None (None here: the exact build at every
    # size).  Set between the two sizes an NVIDIA H100 80GB HBM3 (700 W)
    # timed the builds at in turns (chip_smoke.py, two calls; PERF.md,
    # "Findings"), not from the JAX package's TPU gate (128,000 vertices
    # there).  At 14,400 vertices the exact-free build did not win: +3.1 %
    # and +4.4 % per step on floor-clear 64-step calls, +2.1 % and +3.0 %
    # at 8 sims.  At 250,000 it did: -3.2 % and -2.5 % per step on
    # floor-clear 2,000-step calls, -4.1 % and -4.3 % at 8 sims.  Windows
    # that trip moved either way between the calls (run_steps on the
    # contact scene -2.9 % and -4.7 %; over the megacloth's near-floor
    # window, mostly kernel 2's steps, -6.6 % and +9.2 %).
    CHUNKED_EXACT_FREE_MIN_VERTS = 64000
    # the proximity-gated serving tier under the captured device pass
    # (:meth:`_run_steps_self_collision`), the JAX solver's instance
    # switches and their defaults: False builds no tiers; the longest
    # certified window; the steps of a proximity window; the
    # budget-admitted windows before the exact probe must run.  The pass's
    # distance is not a switch: the pass and the tier both read
    # collisions_device.MIN_DIST, so the certificate holds for the pass.
    self_collision_resident = True
    self_collision_window_cap = 4096
    self_collision_contact_window = 64
    self_collision_budget_windows = 8

    def __init__(self, args, device=None, dtype=None, matmul_dtype=None):
        self.args = args
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device, dtype)
        self.matmul_dtype = storage_dtype(self.dtype, matmul_dtype)
        self.model = None
        self.dirty = True
        self.dt = None
        self.eta = 1.0
        self.frame = 0
        # self-collision: False, True (the host resolvers) or "device",
        # captured at prepare into _collision_mode
        self.enable_self_collision = False
        self._collision_mode = False
        self._collide = None         # the device pass over model.faces
        self._perm_collide = None    # the same over the permuted layout
        self._in_sc_window = False
        self._last_sc_windows = None

        self.reduced_position = getattr(args, "position_reduced", False)
        self.num_pos_modes = getattr(args, "position_num_components", -1)
        self.position_basis_file = getattr(args, "position_basis_file", "")
        self.U = None                                  # (N, r, 3)

        self.constraint_projection_reduction_type = (
            args.constraint_projection_basis_type)
        self.reduced_flags = {
            name: getattr(args, flag)
            for name, (flag, _) in GROUP_ARG_NAMES.items()}
        self.num_components = {
            name: getattr(args, num)
            for name, (_, num) in GROUP_ARG_NAMES.items()}
        self.has_reduced_constraint_projections = any(
            self.reduced_flags.values())
        self.constraint_projection_ready = False
        self._reduced_groups: dict[str, ReducedGroup] = {}
        self._resident = None        # ResidentOperands once prepared
        self._affine = None          # AffineOperands once prepared
        # the tiers of run_steps: tier 1 -> (P, V, steps_done), the contact
        # tier -> (P, V); both called (P, V, fext, rb_extra, steps, iters)
        self._resident_fast = None
        self._resident_run = None
        self._resident_kind = None         # "affine" or "standard"
        self._resident_fast_kind = None    # "chunked", "exit" or None
        self._last_fast_steps = None
        self._last_batched_path = None
        self._chunk_every = 1024     # kernel 5's chunk (its rebase cadence)
        self._chunk_opts = None      # kernel 5's build (ChunkOptions)
        self._contact_mode = False
        self._full = None            # _FullSpace when not fully reduced
        self._chol_full = None       # the dense factor of full positions
        self._solve = None           # the host LU of full positions
        self._ut_st_cache = None
        self._rb_sched = None        # (T, 3, r) on the device when animated
        # recording of the full groups' projections (the host step path)
        self.store_stacked_projections = False
        self.record_path = ""
        self.max_p_snapshots_num = getattr(args, "max_p_snapshots_num", 200)
        self._recorded: dict[str, dict[str, np.ndarray]] = {}

    # ------------------------------------------------------------------
    def set_model(self, model):
        self.model = model
        self._collide = self._perm_collide = None   # keyed on the faces
        self.constraint_projection_ready = False
        self._reduced_groups = {}
        self._resident = None
        self._affine = None
        self.set_dirty()

    def set_dirty(self):
        self.dirty = True
        self._ut_st_cache = None

    def set_clean(self):
        self.dirty = False

    def ready(self):
        return not self.dirty

    def set_record_path(self, path):
        self.record_path = path

    def set_store_p(self, value):
        self.store_stacked_projections = value

    store_assembly_matrices = Solver.store_assembly_matrices
    _record_frame = Solver._record_frame
    flush_recordings = Solver.flush_recordings

    # ------------------------------------------------------------------
    # prepare
    # ------------------------------------------------------------------

    def _load_position_basis(self):
        comps = np.load(self.position_basis_file)
        if hasattr(comps, "files"):
            comps = comps["components"]
        r = self.num_pos_modes if self.num_pos_modes > 0 else comps.shape[0]
        self.U = comps[:r].transpose(1, 0, 2)           # (N, r, 3)

    def prepare_global_matrix(self, args):
        """With positions reduced, the displacement form: solve ``Ar u = c
        - A_c sn`` with ``q = sn + U u``; the pinned-mass rhs terms cancel
        analytically, which keeps the reduced rhs at elastic scale
        (essential in float32).  ``inv(Ar)`` is precomputed per dim in
        float64.  With positions full, a dense Cholesky factor of the global
        matrix on the device in float64 at 3N <= DENSE_LIMIT, else scipy's
        sparse LU on the host; either raises if the factorization fails."""
        self.dt = args.dt
        # velocity damping: the predictor uses s_n = q + dt*eta*v + dt^2
        # M^-1 f with eta = 1 - damping; stored velocities stay (q'-q)/dt
        self.eta = 1.0 - float(getattr(args, "damping", 0.0) or 0.0)
        A = build_global_matrix(self.model, self.dt)
        self._chol_full = self._solve = None
        if not self.reduced_position:
            if A.shape[0] <= self.DENSE_LIMIT:
                self._chol_full = torch.linalg.cholesky(torch.as_tensor(
                    A.toarray(), dtype=PIPELINE_DTYPE, device=self.device))
            else:
                self._solve = scipy.sparse.linalg.factorized(A)
            return
        self._load_position_basis()
        invs, ut_ac = [], []
        dt2_inv = 1.0 / (self.dt * self.dt)
        for d in range(3):
            A_d = A[d::3, d::3]
            Ud = self.U[:, :, d]
            Ar = Ud.T @ (A_d @ Ud)
            invs.append(np.linalg.inv(Ar))
            Ac_d = (A_d - scipy.sparse.diags(
                self.model.mass * dt2_inv)).tocsr()
            ut_ac.append(np.asarray((Ac_d.T @ Ud).T))   # (r, N) dense
        self._inv_np = np.stack(invs)                   # (3, r, r)
        self._ut_ac_np = np.stack(
            [np.asarray(m) for m in ut_ac])             # (3, r, N)

    def prepare_local_term(self, args):
        rtype = self.constraint_projection_reduction_type
        if rtype not in ("deim_pod", "deim_pod_vectorized", "deim_pca_blocks",
                         "geom_pca_blocks_withSt"):
            raise ValueError(
                "Unknown reduction type for constraint projections")
        base_dir = args.geom_interpolation_basis_dir
        fname = args.geom_interpolation_basis_file
        for name, g in self.model.groups.items():
            if name == "positional" or not self.reduced_flags.get(name):
                continue
            npz_path = os.path.join(base_dir, name, fname)
            rg, _, _ = prepare_reduced_group(
                g, rtype, self.num_components[name], npz_path,
                self.model.n_verts, U=self.U,
                oversample=getattr(args, "deim_oversample", 1.0))
            self._reduced_groups[name] = rg

    def prepare(self, args, store_fom_info=False, record_path=None):
        if store_fom_info:
            if record_path is None:
                raise ValueError("store_fom_info needs a record_path")
            self.store_assembly_matrices(record_path)
            self.record_path = record_path
        if self.dirty:
            self.prepare_global_matrix(args)
        if (self.has_reduced_constraint_projections
                and not self.constraint_projection_ready):
            self.prepare_local_term(args)
            self.constraint_projection_ready = True
        self._build_step()
        self.set_clean()

    # ------------------------------------------------------------------
    # step construction
    # ------------------------------------------------------------------

    def _ut_st_np(self):
        """U^T S^T per dim (3, r, e_pos) for the positional group, or None
        without one (cached until set_dirty)."""
        if self._ut_st_cache is not None:
            return self._ut_st_cache
        pos_group = self.model.groups.get("positional")
        if pos_group is None:
            return None
        ST = pos_group.assembly_scipy(self.model.n_verts)
        self._ut_st_cache = np.stack(
            [self.U[:, :, d].T @ ST.toarray() for d in range(3)])
        return self._ut_st_cache

    def _remapped_subsets(self):
        """Union of vertices the reduced kernels touch + subset data with
        vertex indices remapped into the compact union ordering."""
        union = []
        for rg in self._reduced_groups.values():
            for key in VERTEX_KEYS[rg.name]:
                union.append(np.asarray(rg.subset_data[key]).reshape(-1))
        union = np.unique(np.concatenate(union)) if union else np.empty(
            0, np.int64)
        lookup = np.zeros(self.model.n_verts, dtype=np.int64)
        lookup[union] = np.arange(len(union))
        remapped = {}
        for name, rg in self._reduced_groups.items():
            sub = dict(rg.subset_data)
            for key in VERTEX_KEYS[name]:
                sub[key] = lookup[np.asarray(sub[key])]
            remapped[name] = sub
        return union, remapped

    def _build_step(self):
        self._resident = self._affine = None
        self._resident_fast = self._resident_run = None
        self._resident_kind = self._resident_fast_kind = None
        self._rb_sched = None
        self._full = None
        self._perm_collide = None
        # the step cores apply the device pass when it is asked for now;
        # changing the flag afterwards needs set_dirty() + prepare()
        self._collision_mode = self.enable_self_collision
        captured = self._collision_mode == "device"
        model = self.model
        full = [n for n in model.groups
                if n != "positional" and n not in self._reduced_groups]
        if not (self.reduced_position and self._reduced_groups and not full):
            self._full = _FullSpace(
                self, self._model_collide() if captured else None)
            return
        union, remapped = self._remapped_subsets()
        ident = np.arange(len(union))
        packed = []
        for name, rg in self._reduced_groups.items():
            sub = remapped[name]
            if name == "tris_strain":
                packed.append(pack_tris_strain(sub, ident, rg.W,
                                               rg.row_select, np.float64))
            elif name == "edge_spring":
                packed.append(pack_edge_spring(sub, ident, rg.W, np.float64))
            elif name in TET_KINDS:
                packed.append(pack_tets(name, sub, ident, rg.W,
                                        rg.row_select, np.float64))
            else:
                packed.append(pack_verts_bending(sub, ident, rg.W,
                                                 np.float64))
        U_selT = np.ascontiguousarray(
            self.U[union].transpose(2, 1, 0)).astype(np.float64)
        ops = prepare_fused_operands(packed, U_selT, self._inv_np)
        n = model.n_verts
        perm = np.concatenate([union, np.setdiff1d(np.arange(n), union)])
        iperm = np.argsort(perm)
        fused = fused_operands(ops, self.device, self.dtype)
        self._resident = resident_operands(
            fused,
            U_liftT=self.U[perm].transpose(2, 1, 0),       # (3, r, N)
            ut_acT=self._ut_ac_np[:, :, perm],
            mass_inv=1.0 / model.mass[perm],
            perm=perm, iperm=iperm, n_sel=len(union), dt=self.dt,
            eta=self.eta, floor=model.floor_collision,
            floor_h=model.floor_height, matmul_dtype=self.matmul_dtype)
        M_utac = np.stack([self._ut_ac_np[d] @ self.U[:, :, d]
                           for d in range(3)])             # (3, r, r)
        self._affine = affine_operands(self._resident, M_utac, U_selT)
        self._build_tiers(n)
        if captured and not self.self_collision_resident:
            # the pass cannot run inside the tiers' kernels, and without
            # the serving tier they would never serve (JAX
            # sim/reduced.py:561-568): run_steps steps on kernel 1
            self._resident_fast = self._resident_run = None
        total = self._rb_schedule_length()
        if total:
            self._rb_sched = torch.as_tensor(
                self._rb_window_host(0, total), dtype=self.dtype,
                device=self.device)

    def _build_tiers(self, n: int):
        """The tiers of run_steps, as sim/reduced.py:662-824 of the JAX
        package builds them (without its TPU admission gates).

        ``resident_contact_mode=None`` resolves to contact mode wherever
        kernel 3 is the contact tier.  The JAX package turns it on up to
        32,768 vertices for what it gains on a TPU; the port follows what an
        NVIDIA H100 (700 W) measured at the bench scene's 14,400 vertices
        on the cluster loop (``tools/ab_contact_mode.py``, ROADMAP Queue C):
        contact mode at 0.8366x the lean build's time on the contact scene
        and 0.3225x on the crumpling 64-sim ensemble.

        Kernel 5, solo and batched, is built with
        :meth:`_chunk_options`."""
        self._chunk_opts = self._chunk_options(n)
        ao = self._affine
        every = getattr(self, "resident_rebase_every", None)
        contact_mode = getattr(self, "resident_contact_mode", None)
        self._contact_mode = contact_mode is None or bool(contact_mode)
        chunked_tier1 = getattr(self, "resident_chunked_tier1", None)
        if chunked_tier1 is None:
            chunked_tier1 = True
        self._chunk_every = int(every or 1024)
        if chunked_tier1:
            self._resident_fast = partial(affine_chunked, ao,
                                          rebase_every=self._chunk_every,
                                          options=self._chunk_opts)
            self._resident_fast_kind = "chunked"
            if n >= self.CHUNKED_TIER1_MIN_VERTS:
                self._resident_run = partial(resident_multistep, ao.res)
                self._resident_kind = "standard"
                return
        elif self.model.floor_collision and not self._contact_mode:
            self._resident_fast = partial(resident_affine_exit, ao,
                                          rebase_every=int(every or 256))
            self._resident_fast_kind = "exit"
        self._resident_run = partial(
            resident_affine_contact if self._contact_mode else resident_affine,
            ao, rebase_every=int(every or 256))
        self._resident_kind = "affine"

    def _chunked_floor_exact(self, n: int) -> bool:
        """Whether kernel 5 keeps its exact floor check (the JAX
        ``_chunked_floor_exact``): ``resident_floor_exact`` when set, else
        below ``CHUNKED_EXACT_FREE_MIN_VERTS`` vertices (every size when it
        is None).  The exact-free build needs the bound, so
        ``resident_floor_bound_skip = False`` makes it exact."""
        fe = getattr(self, "resident_floor_exact", None)
        if fe is None:
            gate = self.CHUNKED_EXACT_FREE_MIN_VERTS
            fe = gate is None or n < gate
        if not getattr(self, "resident_floor_bound_skip", True):
            fe = True
        return bool(fe)

    def _chunk_options(self, n: int) -> ChunkOptions:
        """Kernel 5's build for a model of ``n`` vertices, from the JAX
        solver's switches: ``resident_floor_bound_skip`` (default True),
        :meth:`_chunked_floor_exact` and the keywords of
        ``resident_chunked_opts`` (``fold_vc``, ``static_rb``,
        ``sqrt_free_bound``; any other key raises ``TypeError``, as the JAX
        function's keywords do, here at ``prepare()``)."""
        return ChunkOptions(
            floor_bound_skip=bool(getattr(self, "resident_floor_bound_skip",
                                          True)),
            floor_exact=self._chunked_floor_exact(n),
            **dict(getattr(self, "resident_chunked_opts", None) or {}))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _require(self):
        if self.dirty:
            raise RuntimeError("call prepare() first")

    def _require_batched(self):
        """:meth:`_require`, and the batched runners' refusal of the host
        LU, which has no batched solve (the JAX solver has no jitted step
        there and raises the same)."""
        self._require()
        if self._full is not None and self._full.mode == "host":
            raise RuntimeError(
                "batched serving needs a device solve (reduced positions or "
                f"3N <= DENSE_LIMIT = {self.DENSE_LIMIT}); this "
                "configuration solves with the host LU")

    # ------------------------------------------------------------------
    # self-collision
    # ------------------------------------------------------------------

    def _model_collide(self):
        """The device pass over the model's faces, (N, 3) positions (made
        once per model)."""
        if self._collide is None:
            self._collide = make_collide(self.model.faces, self.device)
        return self._collide

    def _perm_collide_fn(self):
        """The device pass over the permuted layout: the faces remapped
        through ``iperm`` (distances do not depend on the order of the
        vertices)."""
        if self._perm_collide is None:
            self._perm_collide = make_collide(
                self._resident.iperm[self.model.faces], self.device)
        return self._perm_collide

    def _perm_pass(self, q):
        """The device pass of a permuted (3, N) state."""
        return self._perm_collide_fn()(q.T).T.contiguous()

    def _host_passes(self, q_next):
        """The host resolvers on (N, 3) float64 positions when
        ``enable_self_collision`` is True."""
        if self.enable_self_collision is True:
            return collisions.resolve_self_collisions(q_next,
                                                      self.model.faces)
        return q_next

    def _uncaptured_pass(self):
        """Whether ``step()`` applies the device pass out of band: asked for
        after ``prepare()`` captured no pass."""
        return (self.enable_self_collision == "device"
                and self._collision_mode != "device")

    def _self_collision_clearance(self) -> float:
        """The current minimum vertex-to-non-own-triangle distance over the
        device pass's own candidates, of the model's positions in the
        working dtype."""
        q = torch.as_tensor(self.model.positions, dtype=self.dtype,
                            device=self.device)
        return float(min_clearance_device(q, self._model_collide().faces))

    def _to_device(self, x):
        """(N, 3) host array -> permuted (3, N) tensor on the device (the
        array is cast on the host, so the working dtype's bytes cross)."""
        perm = self._resident.perm
        with annotate("asb.to_device"):
            t = torch.as_tensor(np.ascontiguousarray(np.asarray(x)[perm].T),
                                dtype=self.dtype, device=self.device)
            count_bytes("transfer.h2d_bytes", t)
            return t

    def _to_host(self, x):
        """Permuted (3, N) tensor -> (N, 3) float64 host array."""
        with annotate("asb.to_host"):
            count_bytes("transfer.d2h_bytes", x)
            return x.detach().cpu().numpy().astype(float).T[
                self._resident.iperm]

    def _rb_extra(self, frame=None, targets=None):
        """The positional-target term U^T S^T targets (3, r) of ``targets``
        or of the model's targets at ``frame`` (default: the current frame);
        zero without a positional group."""
        r = self.U.shape[1]
        uts = self._ut_st_np()
        if uts is None:
            rb = np.zeros((3, r))
        else:
            if targets is None:
                targets = self.model.positional_targets(
                    self.frame if frame is None else frame)
            rb = np.einsum("dre,ed->dr", uts, np.asarray(targets))
        return torch.as_tensor(rb, dtype=self.dtype, device=self.device)

    def _rb_window_host(self, start, length):
        """(length, 3, r) float64 target-term rows of the absolute frames
        [start, start + length).  ``rb[t, d] = (U^T S^T)_d targets(t)[:, d]``
        is a static term plus, per ``user_defined`` constraint i, the rank-1
        term ``shift_i[t, d] * (U^T S^T)[d, :, i]``: O(length r) per
        constraint, from its (T_i, 3) shifts."""
        utst = self._ut_st_np()                          # (3, r, e)
        model = self.model
        p0 = np.asarray(model.groups["positional"].data["p0"], dtype=float)
        rb_static = np.einsum("dre,ed->dr", utst, p0)    # (3, r)
        rb = np.repeat(rb_static[None], length, axis=0)  # (length, 3, r)
        t_idx = start + np.arange(length)
        for i, c in enumerate(model._positional):
            if (c["motion_type"] == "user_defined"
                    and c["frame_shift"] is not None):
                sh = np.asarray(c["frame_shift"], dtype=float)
                shf = sh[np.minimum(t_idx, len(sh) - 1)]  # (length, 3)
                rb += shf[:, :, None] * utst[None, :, :, i]
        return rb

    def _rb_schedule_length(self):
        """Frames of the longest ``user_defined`` shift (0: nothing is
        animated)."""
        return max((len(c["frame_shift"]) for c in self.model._positional
                    if c["motion_type"] == "user_defined"
                    and c["frame_shift"] is not None), default=0)

    def _rb_schedule_from(self, frame):
        """The target-term schedule of a call that starts at ``frame``:
        while the targets are animated, the rows of the prepared schedule
        from ``frame`` on (a (T, 3, r) view on the device); after every
        shift has ended, its last row, the static (3, r) term of the
        targets from then on (without animation: that of the targets at
        ``frame``).  step(), run_steps and the recorded run all read their
        rows here, so each sees the same values."""
        sched = self._rb_sched
        if sched is None:
            return self._rb_extra(frame=frame)
        if frame < sched.shape[0]:
            return sched[frame:]
        return sched[-1]

    def _rb_timeline(self, targets_seq, B):
        """The target-term schedule of a caller's timeline: (T, 3, r) of a
        (T, e, 3) timeline that the sims share, (B, T, 3, r) of a per-sim
        (B, T, e, 3) one, contracted in float64 on the host and cast once;
        the static zero term without a positional group."""
        uts = self._ut_st_np()
        tl = _timeline(targets_seq, B, 0 if uts is None else uts.shape[2])
        if uts is None:
            return self._rb_extra()
        return torch.as_tensor(np.einsum("dre,...ted->...tdr", uts, tl),
                               dtype=self.dtype, device=self.device)

    def step(self, fext, num_iterations=10):
        """One step; the iteration loop runs on kernel 1, with the target
        term of the current frame as ``run_steps`` reads it (the prepared
        schedule's row while the targets are animated), then the captured
        device pass.  A configuration that is not fully reduced steps on
        :class:`_FullSpace`.  The device pass asked for after ``prepare()``
        runs out of band, and ``enable_self_collision = True`` runs the host
        resolvers and sets v from the resolved positions."""
        self._require()
        if self._full is not None:
            self._full_step(fext, num_iterations)
            return
        model = self.model
        if model.floor_collision:
            # the step clamps the predictor on the device; mirror the
            # positions_corrections bookkeeping of the host path
            a = np.asarray(fext, dtype=float) / model.mass[:, None]
            sn_raw = (model.positions + self.dt * self.eta * model.velocities
                      + self.dt * self.dt * a)
            _, corr = collisions.resolve_floor_collision(
                sn_raw, model.floor_height)
            model.positions_corrections = corr
        ro = self._resident
        P = self._to_device(model.positions)
        V = self._to_device(model.velocities)
        fa = force_term(ro, self._to_device(fext))
        rb = rb_at(self._rb_schedule_from(self.frame), 0)
        q, v = step_once(ro, P, V, fa, rb, num_iterations,
                         iterate=fused_reduced_iterations)
        if self._collision_mode == "device" or self._uncaptured_pass():
            q = self._perm_pass(q)
            v = (q - P) / ro.dt
        q_next = self._to_host(q)
        if self.enable_self_collision is True:
            q_next = self._host_passes(q_next)
            model.velocities = (q_next - model.positions) / self.dt
        else:
            model.velocities = self._to_host(v)
        model.positions = q_next
        self.frame += 1

    def run_steps(self, fext, num_steps, num_iterations=10, record=False):
        """Advance ``num_steps`` steps on the tiers: tier 1 commits the
        steps before the first one the floor would clamp, and the contact
        tier serves the rest of the window; step i takes the target-term
        row of frame ``self.frame + i`` (:meth:`_rb_schedule_from`), so
        the contact tier continues the schedule where tier 1 stopped.  The
        state crosses to the device at the entry of each tier's call and
        back at its exit.  ``_last_fast_steps == num_steps`` afterwards
        certifies that tier 1, which tests the floor every step, served
        the whole window contact-free.  Spans and counters
        (``utils/profiling.py``): ``asb.run_steps`` around the tiered path,
        ``asb.host_check`` and ``asb.contact_tier`` inside it; the steps
        each tier served in ``steps.tier1`` and ``steps.contact_tier``.

        With ``record=True`` the steps run on kernel 1 instead and the
        (num_steps, N, 3) trajectory of positions is returned
        (:meth:`_run_kernel1`).

        Self-collision (the JAX ``run_steps``, ``sim/reduced.py:2764-2822``):
        the host resolvers, or the device pass asked for after
        ``prepare()``, step through :meth:`step`; with the pass captured
        the proximity-gated tier serves (:meth:`_run_steps_self_collision`),
        or without tiers (``self_collision_resident = False``) kernel 1
        with the pass, step by step on the device."""
        self._last_fast_steps = None
        if not self._in_sc_window:
            self._last_sc_windows = None
        self._require()
        if self.enable_self_collision is True or self._uncaptured_pass():
            traj = []
            for _ in range(num_steps):
                self.step(fext, num_iterations)
                if record:
                    traj.append(self.model.positions.copy())
            return np.array(traj) if record else None
        if self._full is not None:
            return self._full_run(fext, num_steps, num_iterations, record)
        if record:
            return self._run_kernel1(fext, num_steps, num_iterations,
                                     record=True)
        if self._resident_run is None or (
                self.enable_self_collision == "device"
                and not self.self_collision_resident):
            # no tiers (or the serving tier switched off after prepare):
            # kernel 1 with the captured pass, every step
            return self._run_kernel1(fext, num_steps, num_iterations)
        if (self.enable_self_collision == "device"
                and not self._in_sc_window):
            return self._run_steps_self_collision(fext, num_steps,
                                                  num_iterations)
        with annotate("asb.run_steps"):
            model = self.model
            P = self._to_device(model.positions)
            V = self._to_device(model.velocities)
            Fx = self._to_device(fext)
            rb_extra = self._rb_schedule_from(self.frame)
            fast = self._resident_fast
            if fast is not None and model.floor_collision:
                # float64 host check of the step-0 predictor: skip tier 1 when
                # its first step would clamp (floor-off models run kernel 5
                # with the sentinel floor and need no check)
                with annotate("asb.host_check"):
                    sn_y0 = (model.positions[:, 1]
                             + self.dt * self.eta * model.velocities[:, 1]
                             + self.dt * self.dt * np.asarray(fext)[:, 1]
                             / model.mass)
                    if float(sn_y0.min()) < model.floor_height:
                        fast = None
            if fast is not None:
                Pf, Vf, k = fast(P, V, Fx, rb_extra, num_steps, num_iterations)
                if k > 0:
                    count("steps.tier1", k)
                    model.positions = self._to_host(Pf)
                    model.velocities = self._to_host(Vf)
                    self.frame += k
                    if k == num_steps:
                        self._last_fast_steps = k
                        return
                    # contact at step k: the recursion's host check routes the
                    # remainder to the contact tier
                    return self.run_steps(fext, num_steps - k, num_iterations)
                # k == 0: the working-dtype predictor clamped where the float64
                # check did not (a floor-grazing state); recursing would repeat
                # the same call, so the contact tier serves this window
            with annotate("asb.contact_tier"):
                P, V = self._resident_run(P, V, Fx, rb_extra, num_steps,
                                          num_iterations)
            count("steps.contact_tier", num_steps)
            model.positions = self._to_host(P)
            model.velocities = self._to_host(V)
            self.frame += num_steps

    def _run_kernel1(self, fext, num_steps, num_iterations, record=False):
        """``num_steps`` steps on kernel 1, the state on the device, step i
        with the target-term row of frame ``self.frame + i``, each followed
        by the captured device pass.  With ``record`` (the JAX
        ``_run_steps_recorded``) each step's positions go into a
        (num_steps, 3, N) buffer on the device, which crosses to the host
        once -> the (num_steps, N, 3) float64 trajectory; with the floor
        on, ``positions_corrections`` is then the last step's, as
        ``step()`` leaves it (y: the raw predictor less the floor where it
        is below, else 0).  The steps count in ``steps.kernel1``."""
        model, ro = self.model, self._resident
        collide = self._collision_mode == "device"
        P = self._to_device(model.positions)
        V = self._to_device(model.velocities)
        fa = force_term(ro, self._to_device(fext))
        rb = self._rb_schedule_from(self.frame)
        buf = P.new_empty((num_steps,) + tuple(P.shape)) if record else None
        corr_y = torch.zeros_like(P[1])
        for i in range(num_steps):
            if record and model.floor_collision:
                sn_y = P[1] + ro.dt * ro.eta * V[1] + fa[1]
                corr_y = torch.clamp(sn_y - ro.floor_h, max=0.0)
            q, v = step_once(ro, P, V, fa, rb_at(rb, i), num_iterations,
                             iterate=fused_reduced_iterations)
            if collide:
                q = self._perm_pass(q)
                v = (q - P) / ro.dt
            P, V = q, v
            if record:
                buf[i] = P
        model.positions = self._to_host(P)
        model.velocities = self._to_host(V)
        self.frame += num_steps
        count("steps.kernel1", num_steps)
        if not record:
            return None
        count_bytes("transfer.d2h_bytes", buf)
        traj = buf.cpu().numpy().astype(float).transpose(0, 2, 1)[:, ro.iperm]
        if model.floor_collision:
            corr = np.zeros_like(model.positions)
            corr[:, 1] = corr_y.cpu().numpy().astype(float)[ro.iperm]
            model.positions_corrections = corr
        return traj

    def _run_steps_self_collision(self, fext, num_steps, num_iterations):
        """The proximity-gated serving tier under the captured device pass
        (the JAX ``_run_steps_self_collision``, ``sim/reduced.py:2632``).

        The pass is the identity while every vertex stays at least
        ``MIN_DIST`` from its candidate triangles, so a
        window certified clear runs on the tiers without it.  A clearance c
        admits floor(c / (4 dt vmax)) steps (the per-step displacement is
        dt |v|; 2x for two approaching sides, 2x for velocity growth over
        the window): a heuristic, so the clearance is re-checked at every
        window's end and windows are capped at
        ``self_collision_window_cap``.  Without animation, tier 1 serves
        the windows (:meth:`_sc_tier1`); with an animated schedule (or no
        tier 1) each clear window is a nested ``run_steps`` on the tiers
        with the flag off.  Where no window is admitted (proximity, or a
        tier-1 exit at the floor), ``self_collision_contact_window`` steps
        run on kernel 1 with the pass, then the clearance is probed again.
        ``_last_fast_steps`` is set only when tier 1 served every step;
        ``_last_sc_windows`` lists the windows served."""
        model = self.model
        cap = int(self.self_collision_window_cap)
        contact_w = int(self.self_collision_contact_window)
        animated = any(
            c["motion_type"] == "user_defined"
            and c["frame_shift"] is not None
            and len(c["frame_shift"]) > self.frame
            for c in getattr(model, "_positional", []))
        on_tier1 = not animated and self._resident_fast is not None
        tier1 = 0
        remaining = num_steps
        windows = []
        self._in_sc_window = True
        try:
            while remaining > 0:
                if on_tier1:
                    P = self._to_device(model.positions)
                    V = self._to_device(model.velocities)
                    Fx = self._to_device(fext)
                    P, V, done = self._sc_tier1(
                        P, V, Fx, self._rb_schedule_from(self.frame),
                        remaining, num_iterations, windows)
                    model.positions = self._to_host(P)
                    model.velocities = self._to_host(V)
                    self.frame += done
                    tier1 += done
                    remaining -= done
                    if remaining <= 0:
                        break
                else:
                    clearance = self._self_collision_clearance() - MIN_DIST
                    w = 0
                    if clearance > 0:
                        vmax = float(np.linalg.norm(model.velocities,
                                                    axis=1).max())
                        w = int(clearance
                                / (4.0 * self.dt * max(vmax, 1e-12)))
                    if w >= 1:
                        w = min(w, cap, remaining)
                        flag = self.enable_self_collision
                        self.enable_self_collision = False
                        try:
                            self.run_steps(fext, w, num_iterations)
                        finally:
                            self.enable_self_collision = flag
                        windows.append({"path": "tiers", "steps": w,
                                        "tier1": self._last_fast_steps or 0})
                        if self._last_fast_steps:
                            tier1 += self._last_fast_steps
                        remaining -= w
                        continue
                # proximity: kernel 1 with the pass, then probe again
                w = min(contact_w, remaining)
                self._run_kernel1(fext, w, num_iterations)
                windows.append({"path": "per-step", "steps": w})
                remaining -= w
        finally:
            self._in_sc_window = False
        self._last_sc_windows = windows
        self._last_fast_steps = tier1 if tier1 == num_steps else None

    def _sc_tier1(self, P, V, Fx, rb, total, num_iterations, windows):
        """Certified windows on tier 1 from the permuted state (the window
        loop of the JAX ``_sc_fused_runner``, ``sim/reduced.py:2508-2630``,
        here a host loop with the state on the device) -> (P', V', steps
        done), stopping at the first window no clearance admits or at a
        tier-1 exit.

        A clearance budget is carried between windows: each window spends
        its own bound k 4 dt vmax, and the cheap centroid-radius lower bound
        refreshes it (bound <= probe).  The exact probe runs when the
        budget is under one step's 4 dt vmax, or after
        ``self_collision_budget_windows`` windows in a row that the carried
        budget (not the fresh bound) admitted.  The probes take the
        positions in float32, as the JAX loop does; the budget and the
        window lengths are in the working dtype."""
        faces = self._perm_collide_fn().faces
        cap = float(self.self_collision_window_cap)
        max_carry = int(self.self_collision_budget_windows)
        dtype = P.dtype
        budget = torch.zeros((), dtype=dtype, device=P.device)
        nb, done = 0, 0
        while done < total:
            Pt = P.T.to(torch.float32)
            bound = (min_clearance_lower_bound_device(Pt, faces)
                     - MIN_DIST).to(dtype)
            carried = budget
            budget = torch.maximum(budget, bound)
            vmax = torch.sqrt((V * V).sum(dim=0)).max()
            denom = 4.0 * self.dt * torch.clamp(vmax, min=1e-12)
            short, by_carry = (torch.stack([budget < denom, carried > bound])
                               .tolist())
            exact = short or nb >= max_carry
            clearance = ((min_clearance_device(Pt, faces)
                          - MIN_DIST).to(dtype) if exact else budget)
            # consecutive windows admitted by the carried budget
            nb = 0 if exact else (nb + 1 if by_carry else 0)
            w = torch.clamp(torch.nan_to_num(torch.floor(clearance / denom),
                                             nan=0.0), 0.0, cap)
            w = min(int(w), total - done)
            if w < 1:
                break
            P2, V2, k = self._resident_fast(P, V, Fx, rb, w, num_iterations)
            windows.append({"path": "tier 1", "steps": k, "admitted": w,
                            "probe": exact})
            if k > 0:
                P, V = P2, V2
            done += k
            budget = clearance - k * denom
            if k < w:
                break           # a tier-1 exit at the floor
        return P, V, done

    # ------------------------------------------------------------------
    # configurations that are not fully reduced
    # ------------------------------------------------------------------

    def _host_path(self):
        """Whether step() takes the host path: the host LU, or the
        recording of full groups' projections."""
        fs = self._full
        return fs.mode == "host" or (self.store_stacked_projections
                                     and bool(fs.recorded))

    def _full_step(self, fext, num_iterations):
        """step() of a configuration that is not fully reduced."""
        model, fs = self.model, self._full
        if self._host_path():
            self._host_step(fext, num_iterations)
            return
        if model.floor_collision:
            a = np.asarray(fext, dtype=float) / model.mass[:, None]
            sn_raw = (model.positions + self.dt * self.eta * model.velocities
                      + self.dt * self.dt * a)
            _, corr = collisions.resolve_floor_collision(
                sn_raw, model.floor_height)
            model.positions_corrections = corr
        P = fs.tensor(model.positions)
        q, v = fs.step(P, fs.tensor(model.velocities), fs.tensor(fext),
                       fs.tensor(model.positional_targets(self.frame)),
                       num_iterations)
        if self._uncaptured_pass():
            q = self._model_collide()(q)
            v = (q - P) / self.dt
        q_next = q.cpu().numpy()
        if self.enable_self_collision is True:
            q_next = self._host_passes(q_next)
            model.velocities = (q_next - model.positions) / self.dt
        else:
            model.velocities = v.cpu().numpy()
        model.positions = q_next
        self.frame += 1

    def _host_step(self, fext, num_iterations):
        """The JAX solver's host step path (``sim/reduced.py:1315-1358``):
        the local stage on the device, the global solve by the dense factor
        or the host LU, and the full groups' projections recorded when
        ``store_stacked_projections`` is set."""
        if self.reduced_position:
            # W is U^T-composed with positions reduced: the full-space
            # solve below cannot run
            raise RuntimeError(
                "recording full-group projections is not supported with "
                "position reduction while non-reduced constraint groups "
                "are present; disable recording or reduce every group")
        model, fs = self.model, self._full
        dt = self.dt
        dt2 = dt * dt
        a = np.asarray(fext) / model.mass[:, None]
        explicit = model.positions + dt * self.eta * model.velocities \
            + dt2 * a
        if model.floor_collision:
            explicit, corr = collisions.resolve_floor_collision(
                explicit, model.floor_height)
            model.positions_corrections = corr
        targets = fs.tensor(model.positional_targets(self.frame))
        masses_term = fs.tensor((model.mass / dt2)[:, None] * explicit)
        q = fs.tensor(explicit)
        stacked = {}
        for _ in range(num_iterations):
            b, stacked = fs.local_terms(q, targets)
            q = fs.solve(b + masses_term)
        if self.store_stacked_projections:
            self._record_frame(stacked)
        if self.enable_self_collision == "device":
            q = self._model_collide()(q)
        q_next = self._host_passes(q.cpu().numpy())
        model.velocities = (q_next - model.positions) / dt
        model.positions = q_next
        self.frame += 1

    def _full_run(self, fext, num_steps, num_iterations, record):
        """run_steps of a configuration that is not fully reduced: on the
        host path step by step (with the host LU, and when a recorded run
        records the full groups' projections: the JAX solver records them
        in ``step()`` and in a recorded run, not in a plain one); on the
        device modes with the state kept on
        the device, step i with the positional targets of frame
        ``self.frame + i``.  ``record=True`` returns the (num_steps, N, 3)
        trajectory and, with the floor on, leaves ``positions_corrections``
        as the last step's (as the JAX recorded run does)."""
        model, fs = self.model, self._full
        if fs.mode == "host" or (record and self._host_path()):
            traj = []
            for _ in range(num_steps):
                self.step(fext, num_iterations)
                if record:
                    traj.append(model.positions.copy())
            return np.array(traj) if record else None
        tl, _ = positional_targets_timeline(model, self.frame, num_steps)
        tl = fs.tensor(tl)
        P, V = fs.tensor(model.positions), fs.tensor(model.velocities)
        Fx = fs.tensor(fext)
        traj = []
        corr_y = torch.zeros_like(P[:, 1])
        for i in range(num_steps):
            if record and model.floor_collision:
                sn_y = (P[:, 1] + self.dt * self.eta * V[:, 1]
                        + self.dt * self.dt * Fx[:, 1] / fs.mass)
                corr_y = torch.clamp(sn_y - model.floor_height, max=0.0)
            P, V = fs.step(P, V, Fx, tl[min(i, tl.shape[0] - 1)],
                           num_iterations)
            if record:
                traj.append(P)
        model.positions = P.cpu().numpy()
        model.velocities = V.cpu().numpy()
        self.frame += num_steps
        if not record:
            return None
        if model.floor_collision:
            corr = np.zeros_like(model.positions)
            corr[:, 1] = corr_y.cpu().numpy()
            model.positions_corrections = corr
        return (torch.stack(traj).cpu().numpy() if traj
                else np.empty((0,) + model.positions.shape))

    # ------------------------------------------------------------------
    # ensemble serving
    # ------------------------------------------------------------------

    def _pack(self, x):
        """(B, N, 3) host array -> permuted sim-major (B, 3, N) tensor on
        the device.  The permutation is a gather on the device: the host
        only copies the array (and the permutation) across."""
        with annotate("asb.pack"):
            x = torch.as_tensor(np.asarray(x), device=self.device)
            perm = torch.as_tensor(self._resident.perm, device=self.device)
            count_bytes("transfer.h2d_bytes", x, perm)
            return x[:, perm].to(self.dtype).permute(0, 2, 1).contiguous()

    def _unpack(self, x):
        """Permuted (B, 3, N) tensor -> (B, N, 3) float64 host array."""
        with annotate("asb.unpack"):
            iperm = torch.as_tensor(self._resident.iperm, device=x.device)
            out = x.detach()[:, :, iperm].permute(0, 2, 1).double()
            count_bytes("transfer.h2d_bytes", iperm)
            count_bytes("transfer.d2h_bytes", out)
            return out.cpu().numpy()

    def _check_batch(self, positions, velocities, fext):
        """Raise ``ValueError`` unless the three arrays are (B, N, 3) of one
        B for this model: the caller's mistakes raise here, before any
        kernel runs.  Returns B."""
        B = int(np.shape(positions)[0])
        if (int(np.shape(velocities)[0]) != B
                or int(np.shape(fext)[0]) != B):
            raise ValueError(
                f"batch mismatch: positions {B}, velocities "
                f"{np.shape(velocities)[0]}, fext {np.shape(fext)[0]}")
        nv = self.model.n_verts
        for name, arr in (("positions", positions),
                          ("velocities", velocities), ("fext", fext)):
            if tuple(np.shape(arr)[1:]) != (nv, 3):
                raise ValueError(f"{name} must be (B, {nv}, 3) for this "
                                 f"model; got {np.shape(arr)}")
        return B

    @staticmethod
    def _batch_axis(mesh, batch_axis):
        """(process group, size, index) of ``batch_axis`` of ``mesh``, or
        None without a mesh; ``TypeError`` when ``mesh`` is not a
        ``DeviceMesh``."""
        if mesh is None:
            return None
        from animsnapbases_tpu_torch.parallel.collectives import axis_of

        return axis_of(mesh, batch_axis)

    def _sim_block(self, axis, B):
        """[lo, hi) of the sims this rank serves: all B without a mesh,
        else its block of B / n (B a multiple of n)."""
        if axis is None:
            return 0, B
        _, size, index = axis
        if B % size:
            raise ValueError(f"a batch of {B} sims does not split over the "
                             f"{size} ranks of the batch axis")
        bl = B // size
        return index * bl, (index + 1) * bl

    def _gather_sims(self, state, B, mesh, batch_axis, axis):
        """The ranks' blocks of sims (dim 0 of each tensor of ``state``)
        gathered on every rank, and the path named as sharded; ``state``
        as it is without a mesh."""
        if axis is None:
            return state
        from animsnapbases_tpu_torch.parallel.collectives import (
            gather_blocks,
        )

        head, _, tail = self._last_batched_path.partition("+")
        self._last_batched_path = (f"{head}-sharded[{axis[1]}x{B // axis[1]}]"
                                   + (f"+{tail}" if tail else ""))
        with annotate("asb.gather_sims"):
            return tuple(gather_blocks(x, B, mesh, batch_axis)
                         for x in state)

    def _refuse_self_collision(self, captured_ok=False):
        """``make_batched_run`` serves no self-collision: the host
        resolvers and an uncaptured pass cannot run inside its loop, and
        failing beats serving interpenetrating sims.  ``make_batched_step``
        (``captured_ok``) applies a pass captured at prepare to each sim;
        the JAX vmapped step skips the others silently, the port refuses
        them (ROADMAP Queue C)."""
        flag = self.enable_self_collision
        if flag and not (captured_ok and flag == "device"
                         and self._collision_mode == "device"):
            raise RuntimeError("batched serving does not support "
                               "self-collision resolvers")

    def _full_timeline(self, targets_seq, B, start, num_steps):
        """The positional targets of a batched full-space window as a
        float64 (T, e, 3) timeline shared by the sims or (B, T, e, 3) per
        sim: the caller's ``targets_seq`` (:func:`_timeline`), else the
        model's own from frame ``start``."""
        if targets_seq is None:
            tl, _ = positional_targets_timeline(self.model, start, num_steps)
        else:
            tl = _timeline(targets_seq, B, np.shape(
                self.model.positional_targets(start))[0])
        return self._full.tensor(tl)

    def make_batched_step(self, mesh=None, batch_axis: str = "data"):
        """Ensemble stepping: ``step(positions (B, N, 3), velocities,
        fext (B, N, 3), num_iterations=10, targets=None) -> (positions',
        velocities')`` as (B, N, 3) float64 arrays, one step of B
        independent sims, their iteration loops on the batched kernel 1 (one
        block per sim; B = 1 on the solo kernel 1).  ``targets`` (e, 3), the
        positional targets of this call shared by the sims, default to the
        model's targets at a serving frame that starts at the solver's
        frame and advances by one per call.  The prepared state is read at
        call time, so a ``set_dirty()`` + ``prepare()`` rebuild is
        served.  A device pass captured at prepare is applied to each sim
        after its step (:meth:`_refuse_self_collision`).  A configuration
        that is not fully reduced steps on the batched :class:`_FullSpace`
        step in float64.  ``mesh``: each rank of ``batch_axis`` steps its
        block of the sims and the blocks are gathered on every rank (see
        the module docstring)."""
        axis = self._batch_axis(mesh, batch_axis)
        serving_frame = [self.frame]

        def step(positions, velocities, fext, num_iterations=10,
                 targets=None):
            self._refuse_self_collision(captured_ok=True)
            B = self._check_batch(positions, velocities, fext)
            self._require_batched()
            lo, hi = self._sim_block(axis, B)
            positions, velocities = positions[lo:hi], velocities[lo:hi]
            fext = fext[lo:hi]
            if self._full is not None:
                fs = self._full
                t = fs.tensor(self.model.positional_targets(serving_frame[0])
                              if targets is None else targets)
                self._last_batched_path = "batched-full"
                q, v = fs.step(fs.tensor(positions), fs.tensor(velocities),
                               fs.tensor(fext), t, num_iterations)
                q, v = self._gather_sims((q, v), B, mesh, batch_axis, axis)
                serving_frame[0] += 1
                return q.cpu().numpy(), v.cpu().numpy()
            ro = self._resident
            P, V = self._pack(positions), self._pack(velocities)
            fa = force_term(ro, self._pack(fext))
            rb = self._rb_extra(frame=serving_frame[0], targets=targets)
            sn, rb_const = predict(ro, P, V, fa, rb)
            self._last_batched_path = "batched-step"
            if hi - lo == 1:
                u = fused_reduced_iterations(
                    ro.fused, sn[0, :, :ro.n_sel], rb_const[0].contiguous(),
                    num_iterations)[None]
            else:
                u = fused_reduced_iterations_batched(
                    ro.fused, sn[..., :ro.n_sel], rb_const.contiguous(),
                    num_iterations)
            q, v = lift(ro, P, sn, u)
            if self._collision_mode == "device":
                q = torch.stack([self._perm_pass(x) for x in q])
                v = (q - P) / ro.dt
            q, v = self._gather_sims((q, v), B, mesh, batch_axis, axis)
            serving_frame[0] += 1
            return self._unpack(q), self._unpack(v)

        return step

    def make_batched_run(self, mesh=None, batch_axis: str = "data"):
        """Ensemble serving: ``run(positions (B, N, 3), velocities,
        fext (B, N, 3), num_steps, num_iterations=10, targets_seq=None) ->
        (positions', velocities')`` as (B, N, 3) float64 arrays, B
        independent sims advanced ``num_steps`` steps.  ``targets_seq`` is
        the positional-target timeline of the call's steps, step i taking
        row min(i, T - 1): (T, e, 3) shared by the sims or (B, T, e, 3)
        per sim (:meth:`_rb_timeline`).  Without it the sims follow the
        model's own target schedule from a serving frame that starts at
        the solver's frame and advances by ``num_steps`` per call, so
        consecutive calls continue an animation.  The prepared state is
        read at call time, so a ``set_dirty()`` + ``prepare()`` rebuild is
        served by a runner made before it.

        Below ``CHUNKED_TIER1_MIN_VERTS`` vertices one call of the batched
        kernel 3 (its contact-mode build unless ``resident_contact_mode``
        is False) serves the window; at or above it the batched kernel 5
        serves contact-free stretches and the batched kernel 2 the windows
        after a whole-batch exit (:meth:`_run_batched_chunked`).  A
        configuration that is not fully reduced runs the batched
        :class:`_FullSpace` step (:meth:`_run_batched_full`).  ``mesh``:
        each rank of ``batch_axis`` serves its block of the sims and the
        blocks are gathered on every rank (see the module docstring).
        Spans (``utils/profiling.py``): ``asb.batched_run`` around a call,
        ``asb.pack``, ``asb.unpack``, ``asb.batched_kernel`` (the route's
        call) and ``asb.gather_sims`` inside it."""
        axis = self._batch_axis(mesh, batch_axis)
        self._refuse_self_collision()
        serving_frame = [self.frame]

        def run(positions, velocities, fext, num_steps, num_iterations=10,
                targets_seq=None):
            with annotate("asb.batched_run"):
                self._refuse_self_collision()
                B = self._check_batch(positions, velocities, fext)
                self._require_batched()
                lo, hi = self._sim_block(axis, B)
                positions, velocities = positions[lo:hi], velocities[lo:hi]
                fext = fext[lo:hi]
                if self._full is not None:
                    tl = self._full_timeline(targets_seq, B, serving_frame[0],
                                             int(num_steps))
                    with annotate("asb.batched_kernel"):
                        P, V = self._run_batched_full(
                            positions, velocities, fext, int(num_steps),
                            num_iterations, tl[lo:hi] if tl.dim() == 4 else tl)
                    P, V = self._gather_sims((P, V), B, mesh, batch_axis, axis)
                    serving_frame[0] += int(num_steps)
                    return P.cpu().numpy(), V.cpu().numpy()
                rb = (self._rb_schedule_from(serving_frame[0])
                      if targets_seq is None
                      else self._rb_timeline(targets_seq, B))
                if rb.dim() == 4:
                    rb = rb[lo:hi]
                P, V = self._pack(positions), self._pack(velocities)
                Fx = self._pack(fext)
                with annotate("asb.batched_kernel"):
                    if self._resident_kind == "standard":
                        P, V = self._run_batched_chunked(
                            P, V, Fx, rb, int(num_steps), num_iterations,
                            None if axis is None else axis[0])
                    else:
                        P, V = self._run_batched_resident(P, V, Fx, rb,
                                                          int(num_steps),
                                                          num_iterations)
                P, V = self._gather_sims((P, V), B, mesh, batch_axis, axis)
                serving_frame[0] += int(num_steps)
                return self._unpack(P), self._unpack(V)

        return run

    def _run_batched_full(self, positions, velocities, fext, num_steps,
                          num_iterations, tl):
        """The window of a configuration that is not fully reduced: the
        batched :class:`_FullSpace` step on (B, N, 3) float64 state on the
        device, step i with row min(i, T - 1) of the timeline ``tl``
        (shared (T, e, 3) or per sim (B, T, e, 3)) -> (B, N, 3) float64
        tensors on the device."""
        fs = self._full
        self._last_batched_path = "batched-full"
        P, V = fs.tensor(positions), fs.tensor(velocities)
        Fx = fs.tensor(fext)
        T = tl.shape[-3]
        for i in range(num_steps):
            P, V = fs.step(P, V, Fx, tl[..., min(i, T - 1), :, :],
                           num_iterations)
        return P, V

    def _run_batched_resident(self, P, V, Fx, rb, num_steps, num_iterations):
        """The window on the batched kernel 3, lean or in contact mode as
        the solver's contact tier is (B = 1: the solo kernel 3), one call
        for the whole batch; ``rb`` the target-term schedule, shared or
        per sim.  Counts the sims' steps in ``sim_steps.batched_resident``."""
        every = int(getattr(self, "resident_rebase_every", None) or 256)
        self._last_batched_path = "batched-resident"
        count("sim_steps.batched_resident", P.shape[0] * num_steps)
        solo, batched = ((resident_affine_contact,
                          resident_affine_contact_batched)
                         if self._contact_mode else
                         (resident_affine, resident_affine_batched))
        if P.shape[0] == 1:
            out = solo(self._affine, P[0], V[0], Fx[0], _sim0(rb), num_steps,
                       num_iterations, rebase_every=every)
            return out[0][None], out[1][None]
        return batched(self._affine, P, V, Fx, rb, num_steps, num_iterations,
                       rebase_every=every)

    def _run_batched_chunked(self, P, V, Fx, rb, num_steps, num_iterations,
                             group=None):
        """The large-model route (JAX ``_run_batched_resident_chunked``):
        the batched kernel 5 commits the steps before the first one at
        which any sim would clamp; a window of
        ``max(resident_rebase_every or 1024, ceil(num_steps / 64))`` steps
        then runs on the batched kernel 2, and stepping hands back to
        kernel 5.  B = 1 runs the solo kernels 5 and 2.  Each call takes
        the target-term schedule ``rb`` from its own first step on.  With
        the process ``group`` of a batch axis the ranks agree on each
        commit (:func:`_agree_on_k`).  Counts the sims' steps in
        ``sim_steps.batched_chunked``."""
        ao = self._affine
        solo = P.shape[0] == 1
        count("sim_steps.batched_chunked", P.shape[0] * num_steps)
        if solo:
            rb = _sim0(rb)
        window = max(int(getattr(self, "resident_rebase_every", None)
                         or 1024), -(-num_steps // 64))
        remaining, windows = num_steps, 0
        self._last_batched_path = "batched-chunked"
        def serve(rb_now, budget):
            if solo:
                Pf, Vf, k = affine_chunked(ao, P[0], V[0], Fx[0], rb_now,
                                           budget, num_iterations,
                                           rebase_every=self._chunk_every,
                                           options=self._chunk_opts)
                return Pf[None], Vf[None], k
            return affine_chunked_batched(
                ao, P, V, Fx, rb_now, budget, num_iterations,
                rebase_every=self._chunk_every, options=self._chunk_opts)

        while remaining > 0:
            rb_now = rb_from(rb, num_steps - remaining)
            Pf, Vf, k = serve(rb_now, remaining)
            if group is not None:
                Pf, Vf, k = _agree_on_k(serve, rb_now, Pf, Vf, k, group)
            if k > 0:
                P, V = Pf, Vf
                remaining -= k
            if remaining <= 0:
                break
            # whole-batch contact: a bounded window on kernel 2, then back
            w = min(remaining, window)
            rb_now = rb_from(rb, num_steps - remaining)
            if solo:
                P, V = (x[None] for x in resident_multistep(
                    ao.res, P[0], V[0], Fx[0], rb_now, w, num_iterations))
            else:
                P, V = resident_multistep_batched(ao.res, P, V, Fx, rb_now, w,
                                                  num_iterations)
            remaining -= w
            windows += 1
        if windows:
            self._last_batched_path = f"batched-chunked+perstep[{windows}w]"
        return P, V


def _agree_on_k(serve, rb_now, Pf, Vf, k, group, probes=3):
    """Lockstep of a sharded batched kernel-5 call (JAX
    ``_run_batched_resident_chunked_sharded``): the ranks' committed steps
    k agree through one ``all_reduce`` (of [-k, k], MAX); where they differ,
    each rank serves again for the least k, which every rank can commit
    (kernel 5 is deterministic, and no sim clamped before it), up to
    ``probes`` times.  Returns the state and k to commit (0: none, the
    caller's window on kernel 2 follows on every rank)."""
    import torch.distributed as dist

    for _ in range(probes + 1):
        both = torch.tensor([-k, k], dtype=torch.int64, device=Pf.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        kmin, kmax = -int(both[0]), int(both[1])
        if kmin == kmax or kmin == 0:
            return Pf, Vf, kmin
        Pf, Vf, k = serve(rb_now, kmin)
    return Pf, Vf, 0


def _timeline(targets_seq, B, e):
    """A caller's positional-target timeline as a float64 array, (T, e, 3)
    shared by the sims or (B, T, e, 3) per sim; raises ``ValueError`` on a
    shape that does not fit a model of ``e`` targets and a batch of B."""
    tl = np.asarray(targets_seq, dtype=np.float64)
    if (tl.ndim not in (3, 4) or tuple(tl.shape[-2:]) != (e, 3)
            or tl.shape[-3] < 1):
        raise ValueError(f"targets_seq must be (T, {e}, 3) or (B, T, {e}, 3)"
                         f" for this model; got {tl.shape}")
    if tl.ndim == 4 and tl.shape[0] != B:
        raise ValueError(f"per-sim targets_seq has batch {tl.shape[0]}, "
                         f"expected {B}")
    return tl


def _sim0(rb):
    """A batch's target-term schedule as its one sim's: a per-sim
    (1, T, 3, r) schedule loses its sim axis."""
    return rb[0] if rb.dim() == 4 else rb
