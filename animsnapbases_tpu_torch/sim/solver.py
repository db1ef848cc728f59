"""Full-order projective-dynamics solver and the global-matrix assembly.

Counterpart of ``animsnapbases_tpu/sim/solver.py``: ``Solver`` (explicit
predictor, floor collision, ``num_iterations`` local-global sweeps with a
prefactored global solve, per-frame recording of the trajectory and of the
stacked projections p), ``build_global_matrix`` (which the reduced solver
shares), ``make_local_stage``, the per-dimension constraint block
(``group_dim_triplets``, ``build_constraint_dim_coo``),
``positional_targets_timeline`` and ``make_device_global_solve`` (the dense
and CG solves of one iteration, which ``Solver`` and the sharded steps of
``parallel/`` share).

The local stage (every group's projections and S^T p, ``sim/projections.py``)
runs on the solver's device, in ``device.PIPELINE_DTYPE`` (float64) on the
card as on the CPU.  Global-solve tiers (``global_solve``):

* ``"host"`` -- scipy's sparse LU (``factorized``) on the host, the tier
  the JAX bench records with: b and q cross between the card and the host
  once per iteration (``seconds`` splits the time into the local stage,
  the transfers and the LU solves);
* ``"dense"`` -- a dense Cholesky factor on the device
  (``torch.linalg.cholesky`` / ``cholesky_solve``) for 3N <= DENSE_LIMIT;
* ``"cg"`` -- Jacobi-preconditioned CG on the device in displacement form,
  warm-started from the previous iteration (``ops/cg.py``);
* ``"auto"`` -- dense up to DENSE_LIMIT, else CG.

Self-collision (``enable_self_collision``): False (the default) runs no
pass; ``"device"`` applies the masked pass of ``sim/collisions_device.py``
to q on the device after each step's sweep, before v = (q - P)/dt, in
``step()`` and in every step of ``run_steps``; True runs the two host
resolvers of ``sim/collisions.py`` after each step, and ``run_steps`` then
steps through :meth:`Solver.step`.
"""

from __future__ import annotations

import os
import time

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device
from animsnapbases_tpu_torch.ops import segment
from animsnapbases_tpu_torch.ops.cg import build_ell, ell_matvec, make_pcg_solver
from animsnapbases_tpu_torch.sim import collisions, projections
from animsnapbases_tpu_torch.sim.collisions_device import make_collide


def flatten(p: np.ndarray) -> np.ndarray:
    return p.reshape(-1)


def unflatten(q: np.ndarray) -> np.ndarray:
    return q.reshape(-1, 3)


def device_data(data: dict, device, dtype) -> dict:
    """A group's arrays (its ``data``, or a subset of it) as tensors on
    ``device`` (floats in ``dtype``); scalars and object arrays as they
    are."""
    out = {}
    for k, v in data.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            t = torch.as_tensor(v, device=device)
            out[k] = t.to(dtype) if t.is_floating_point() else t
        else:
            out[k] = v
    return out


def device_group_data(g, device, dtype):
    """The group's arrays as tensors on ``device`` (:func:`device_data`)."""
    return device_data(g.data, device, dtype)


def batch_data(name: str, data: dict, B: int, n: int) -> dict:
    """A group's tensors (:func:`device_data`) for B sims stacked along the
    vertex axis, sim b's vertices at rows b*n to (b + 1)*n: the index
    arrays of ``projections.VERTEX_KEYS`` offset by b*n, every other array
    repeated B times along its element axis, scalars as they are.  A
    projection of the stacked (B*n, 3) positions is then the B sims'
    projections, sim after sim, each element computed as for one sim."""
    keys = projections.VERTEX_KEYS[name]
    out = {}
    for k, v in data.items():
        if not torch.is_tensor(v) or v.dim() == 0:
            out[k] = v
        elif k in keys:
            off = torch.arange(B, device=v.device) * n
            out[k] = (v[None] + off.reshape((B,) + (1,) * v.dim())) \
                .reshape((-1,) + tuple(v.shape[1:]))
        else:
            out[k] = v.repeat((B,) + (1,) * (v.dim() - 1))
    return out


def make_local_stage(model, device=None, dtype=PIPELINE_DTYPE, batch=None):
    """The local stage of the model's current groups:
    ``local(q, positional_targets) -> (b, {name: stacked_p})`` with b =
    sum over groups of S^T p, each product summed in a fixed order
    (``ops/segment.py``), so that two runs on the card agree bit for
    bit.  With ``batch`` = B it is the stage of B sims in one pass: q (B,
    N, 3), the targets (e, 3) shared or (B, e, 3) per sim, b (B, N, 3) and
    each stacked p (B, e*p, 3); the sims lie one after another on the
    vertex axis (:func:`batch_data`), S^T block-diagonal, each sim's rows
    summed in the single sim's order."""
    device = resolve_device(device)
    n = model.n_verts
    B = 1 if batch is None else int(batch)
    static = []
    for name, g in model.groups.items():
        rows, cols = np.asarray(g.st_rows), np.asarray(g.st_cols)
        vals = np.asarray(g.st_vals)
        data = device_group_data(g, device, dtype)
        if batch is not None:
            width = g.num * g.p
            rows = (rows[None] + n * np.arange(B)[:, None]).reshape(-1)
            cols = (cols[None] + width * np.arange(B)[:, None]).reshape(-1)
            vals = np.tile(vals, B)
            if name != "positional":
                data = batch_data(name, data, B, n)
        layout = segment.row_layout(
            rows, cols, torch.as_tensor(vals, dtype=dtype, device=device),
            B * n)
        static.append((name, data, layout))

    def local(q, positional_targets):
        if batch is not None:
            q = q.reshape(B * n, 3)
            positional_targets = positional_targets.expand(
                (B,) + tuple(positional_targets.shape[-2:])).reshape(-1, 3)
        b = torch.zeros((B * n, 3), dtype=q.dtype, device=q.device)
        stacked = {}
        for name, data, layout in static:
            if name == "positional":
                p = projections.positional_p(positional_targets)
            else:
                p = projections.PROJECTION_KERNELS[name](q, data)
            stacked[name] = p if batch is None else p.reshape(B, -1, 3)
            b = b + segment.row_sum(layout, p)
        return (b, stacked) if batch is None else (b.reshape(B, n, 3),
                                                   stacked)

    return local


def build_global_matrix(model, dt: float):
    """(mass/dt^2) I + sum of group LHS triplets, as scipy CSC (3N, 3N)."""
    n = model.n_verts
    rows = [np.arange(3 * n)]
    cols = [np.arange(3 * n)]
    vals = [np.repeat(model.mass, 3) / (dt * dt)]
    for g in model.groups.values():
        rows.append(g.lhs_rows)
        cols.append(g.lhs_cols)
        vals.append(g.lhs_vals)
    return scipy.sparse.csc_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(3 * n, 3 * n))


def group_dim_triplets(g):
    """One group's per-dimension (N, N) LHS block as COO triplets: every
    group couples equal dimensions only, with the same values in each, so
    the d = 0 entries describe the block."""
    if g.lhs_rows is None or len(g.lhs_rows) == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0)
    m = (g.lhs_rows % 3 == 0) & (g.lhs_cols % 3 == 0)
    return g.lhs_rows[m] // 3, g.lhs_cols[m] // 3, g.lhs_vals[m]


def build_constraint_dim_coo(model):
    """COO triplets of the per-dimension constraint block A_c (N, N), so
    that A_d = A_c + diag(mass/dt^2) for every dimension d."""
    rows, cols, vals = [], [], []
    for g in model.groups.values():
        r, c, v = group_dim_triplets(g)
        if len(r):
            rows.append(r)
            cols.append(c)
            vals.append(v)
    if not rows:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), np.empty(0)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


class Solver:
    """Full-order PD solver with the reference's prepare/step API (see the
    module docstring for the global-solve tiers)."""

    DENSE_LIMIT = 2400  # max 3N for the dense Cholesky tier
    CG_TOL = 1e-11      # relative preconditioned-residual tolerance
    CG_MAX_ITERS = 500

    def __init__(self, global_solve: str = "auto", device=None):
        self.device = resolve_device(device)
        self.dtype = PIPELINE_DTYPE
        self.model = None
        self.global_solve = global_solve
        self.dirty = True
        self.dt = None
        self.eta = 1.0
        self.frame = 0
        self._mode = None
        self._local = None
        self._local_key = None
        # recording
        self.store_stacked_projections = False
        self.record_path = ""
        self.max_p_snapshots_num = 200
        self._recorded: dict[str, dict[str, np.ndarray]] = {}
        # self-collision: False, True (the host resolvers) or "device"
        self.enable_self_collision = False
        self._collide = None         # the device pass over model.faces
        # seconds of the host tier's iterations: the local stage on the
        # device, the transfers of b and q, the LU solves
        self.seconds = {"local": 0.0, "transfer": 0.0, "solve": 0.0}

    # ------------------------------------------------------------------
    def set_model(self, model):
        self.model = model
        self._collide = None         # keyed on the faces: now stale
        self.set_dirty()

    def set_dirty(self):
        self.dirty = True

    def set_clean(self):
        self.dirty = False

    def ready(self):
        return not self.dirty

    def set_record_path(self, path: str):
        self.record_path = path

    def set_store_p(self, value: bool):
        self.store_stacked_projections = value

    def _collide_device(self, q):
        """The device pass over the model's faces (made once per
        model)."""
        if self._collide is None:
            self._collide = make_collide(self.model.faces, self.device)
        return self._collide(q)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def store_assembly_matrices(self, record_path: str):
        """``assembly_ST.npz`` (scipy S^T per group, as object arrays) and,
        with a bending group, ``verts_bending_constrained_indices.npz``."""
        os.makedirs(record_path, exist_ok=True)
        matrices = self.model.assembly_matrices()
        if self.model.has_group("verts_bending"):
            np.savez(os.path.join(record_path,
                                  "verts_bending_constrained_indices.npz"),
                     indices=np.asarray(
                         self.model.groups["verts_bending"].data["indices"]))
        np.savez(os.path.join(record_path, "assembly_ST.npz"), **matrices)

    def prepare(self, args, store_fom_info=False, record_path=None):
        if store_fom_info:
            if record_path is None:
                raise ValueError("store_fom_info needs a record_path")
            self.store_assembly_matrices(record_path)
            self.record_path = record_path
        self.dt = args.dt
        # s_n = q + dt*eta*v + dt^2 M^-1 f, v = (q_new - q)/dt
        self.eta = 1.0 - float(getattr(args, "damping", 0.0) or 0.0)
        self.max_p_snapshots_num = getattr(args, "max_p_snapshots_num",
                                           self.max_p_snapshots_num)
        model = self.model
        mode = self.global_solve
        if mode == "auto":
            mode = "dense" if 3 * model.n_verts <= self.DENSE_LIMIT else "cg"
        if mode in ("dense", "cg"):
            self._prep, self._apply = make_device_global_solve(
                model, self.dt, self.device, self.dtype,
                dense_limit=float("inf") if mode == "dense" else 0,
                cg_tol=self.CG_TOL, cg_max_iters=self.CG_MAX_ITERS)
        elif mode == "host":
            self._solve = scipy.sparse.linalg.factorized(
                build_global_matrix(model, self.dt))
        else:
            raise ValueError(f"unknown global_solve mode {mode!r}")
        self._mode = mode
        # the local stage holds the groups' rest data: rebuild it only when
        # the group structure changed
        local_key = tuple((name, id(g)) for name, g in model.groups.items())
        if self._local_key != local_key:
            self._local = make_local_stage(model, self.device, self.dtype)
            self._local_key = local_key
        self.set_clean()

    # ------------------------------------------------------------------
    def _sweep(self, sn, targets, num_iterations):
        """The device tiers' local-global sweep from the predictor sn: at
        least one iteration, as the JAX sweep, on the solve of
        :func:`make_device_global_solve`."""
        ctx = self._prep(sn)
        q, u = sn, torch.zeros_like(sn)
        stacked = {}
        for _ in range(max(num_iterations, 1)):
            c, stacked = self._local(q, targets)
            q, u = self._apply(c, sn, u, ctx)
        return q, stacked

    def _host_sweep(self, sn, targets, num_iterations):
        """The host tier: the local stage on the device, the LU solve on the
        host, b and q crossing once per iteration."""
        dt2 = self.dt * self.dt
        masses_term = self._tensor((self.model.mass / dt2)[:, None] * sn)
        q = self._tensor(sn)
        stacked = {}
        sec = self.seconds
        for _ in range(num_iterations):
            t0 = time.perf_counter()
            b, stacked = self._local(q, targets)
            b = b + masses_term
            self._sync()
            t1 = time.perf_counter()
            b_host = b.cpu().numpy().reshape(-1)
            t2 = time.perf_counter()
            q_host = self._solve(b_host)
            t3 = time.perf_counter()
            q = self._tensor(unflatten(q_host))
            t4 = time.perf_counter()
            sec["local"] += t1 - t0
            sec["transfer"] += (t2 - t1) + (t4 - t3)
            sec["solve"] += t3 - t2
        return q, stacked

    def step(self, fext, num_iterations=10):
        model = self.model
        dt = self.dt
        dt2 = dt * dt
        a = fext / model.mass[:, None]
        explicit = model.positions + dt * self.eta * model.velocities \
            + dt2 * a
        if model.floor_collision:
            explicit, corrections = collisions.resolve_floor_collision(
                explicit, model.floor_height)
            model.positions_corrections = corrections
        targets = self._tensor(model.positional_targets(self.frame))
        if self._mode == "host":
            q, stacked = self._host_sweep(explicit, targets, num_iterations)
        else:
            q, stacked = self._sweep(self._tensor(explicit), targets,
                                     num_iterations)
        if self.store_stacked_projections:
            self._record_frame(stacked)
        if self.enable_self_collision == "device":
            q = self._collide_device(q)
        q_next = q.cpu().numpy()
        if self.enable_self_collision is True:
            q_next = collisions.resolve_self_collisions(q_next, model.faces)
        model.velocities = (q_next - model.positions) * (1.0 / dt)
        model.positions = q_next
        self.frame += 1

    # ------------------------------------------------------------------
    def run_steps(self, fext, num_steps, num_iterations=10, record=False):
        """Advance ``num_steps`` steps; with ``record=True`` return the
        (T, N, 3) trajectory.  The host tier and the host resolvers
        (``enable_self_collision = True``) step through :meth:`step`; the
        device tiers keep the state on the device between steps, with the
        device pass in each step under ``"device"``."""
        model = self.model
        if self._mode == "host" or self.enable_self_collision is True:
            traj = []
            for _ in range(num_steps):
                self.step(fext, num_iterations)
                if record:
                    traj.append(model.positions.copy())
            return np.array(traj) if record else None
        dt = self.dt
        dtv = dt * self.eta
        dt2 = dt * dt
        pos = self._tensor(model.positions)
        vel = self._tensor(model.velocities)
        a = self._tensor(fext) / self._tensor(model.mass)[:, None]
        corr = torch.zeros_like(pos)
        traj = []
        for _ in range(num_steps):
            sn_raw = pos + dtv * vel + dt2 * a
            sn = sn_raw
            if model.floor_collision:
                sn = sn_raw.clone()
                sn[:, 1] = torch.clamp(sn_raw[:, 1], min=model.floor_height)
            q, stacked = self._sweep(
                sn, self._tensor(model.positional_targets(self.frame)),
                num_iterations)
            if self.enable_self_collision == "device":
                q = self._collide_device(q)
            vel = (q - pos) / dt
            pos = q
            corr = sn_raw - sn
            if record:
                traj.append(q)
            if self.store_stacked_projections:
                self._record_frame(stacked)
            self.frame += 1
        model.positions = pos.cpu().numpy()
        model.velocities = vel.cpu().numpy()
        if model.floor_collision:
            model.positions_corrections = corr.cpu().numpy()
        if record:
            return (torch.stack(traj).cpu().numpy() if traj
                    else np.empty((0,) + model.positions.shape))
        return None

    # ------------------------------------------------------------------
    def _record_frame(self, stacked: dict):
        """Keep the last iteration's stacked p per group under the frame's
        key; flush each group to <name>_p.npz when the frame counter
        reaches max_p_snapshots_num."""
        for name, p in stacked.items():
            if name == "positional":
                continue
            self._recorded.setdefault(name, {})[str(self.frame)] = (
                p.cpu().numpy())
        if self.frame == self.max_p_snapshots_num and self.record_path:
            self.flush_recordings()

    def flush_recordings(self):
        """Write every recorded group to <name>_p.npz, one key per frame
        ("0", "1", ...)."""
        if not self.record_path or not self._recorded:
            return
        os.makedirs(self.record_path, exist_ok=True)
        for name, frames in self._recorded.items():
            np.savez(os.path.join(self.record_path, name + "_p.npz"),
                     **frames)


def positional_targets_timeline(model, frame: int, num_steps: int):
    """(T, e, 3) per-frame positional-target timeline starting at ``frame``
    -> (timeline, animated).

    Frame shifts index by absolute frame and clamp at their last entry, so
    the timeline covers only the longest remaining shift: T = 1 (the
    targets at ``frame``) when nothing is animated, else min(num_steps,
    remaining).  A consumer indexes it with min(i, T - 1), which repeats
    the last row past its end.  (The JAX package pads an animated timeline
    to a power of two to reuse its compilations; the padding repeats the
    last row, so the clamped index reads the same values.)"""
    remaining = 0
    for c in getattr(model, "_positional", []):
        if (c["motion_type"] == "user_defined"
                and c["frame_shift"] is not None):
            remaining = max(remaining, len(c["frame_shift"]) - frame)
    if remaining <= 0:
        return np.asarray(model.positional_targets(frame))[None], False
    t_eff = min(num_steps, remaining)
    p0 = model.groups["positional"].data["p0"]
    tl = np.repeat(np.asarray(p0, dtype=float)[None], t_eff, axis=0)
    frames = frame + np.arange(t_eff)
    for i, c in enumerate(model._positional):
        if (c["motion_type"] == "user_defined"
                and c["frame_shift"] is not None):
            shift = c["frame_shift"]
            tl[:, i] += shift[np.minimum(frames, len(shift) - 1)]
    return tl, True


def make_device_global_solve(model, dt: float, device=None,
                             dtype=PIPELINE_DTYPE,
                             dense_limit: float | None = None,
                             cg_tol: float | None = None,
                             cg_max_iters: int | None = None):
    """The global solve of one local-global iteration on ``device`` (default
    the card) in ``dtype`` -> ``(prep, apply)``:

    * ``prep(sn) -> ctx``, once a step: the masses term (dense) or the
      displacement form's constant -A_c s_n (CG);
    * ``apply(c, sn, u_prev, ctx) -> (q, u)``, once an iteration, ``c`` the
      summed constraint term sum S^T p and ``u_prev`` the CG's warm start
      (the dense solve ignores it).

    At 3N <= ``dense_limit`` (default ``Solver.DENSE_LIMIT``) a dense
    Cholesky factor of the global matrix; above it Jacobi-preconditioned CG
    (``ops/cg.py``) in displacement form on the per-dimension matrix in
    ELL form, with no dense matrix, so a large model steps on it."""
    dense_limit = Solver.DENSE_LIMIT if dense_limit is None else dense_limit
    cg_tol = Solver.CG_TOL if cg_tol is None else cg_tol
    cg_max_iters = (Solver.CG_MAX_ITERS if cg_max_iters is None
                    else cg_max_iters)
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    n = model.n_verts
    mass_dt2 = tensor(model.mass / (dt * dt))
    if 3 * n <= dense_limit:
        chol = torch.linalg.cholesky(tensor(
            build_global_matrix(model, dt).toarray()))

        def prep(sn):
            return mass_dt2[:, None] * sn

        def apply(c, sn, u_prev, ctx):
            q = torch.cholesky_solve((c + ctx).reshape(-1, 1),
                                     chol).reshape(-1, 3)
            return q, q - sn

        return prep, apply

    ac_rows, ac_cols, ac_vals = build_constraint_dim_coo(model)
    mass_diag = np.asarray(model.mass / (dt * dt), dtype=float)
    diag = mass_diag.copy()
    on_diag = ac_rows == ac_cols
    np.add.at(diag, ac_rows[on_diag], ac_vals[on_diag])
    ell_cols, ell_vals = build_ell(ac_rows, ac_cols, ac_vals, n,
                                   diag_add=mass_diag)
    ell = (torch.as_tensor(ell_cols.astype(np.int64), device=dev),
           tensor(ell_vals))

    def matvec(x):
        return ell_matvec(*ell, x)

    cg = make_pcg_solver(None, None, None, tensor(diag), n, tol=cg_tol,
                         max_iters=cg_max_iters, matvec=matvec)

    def prep(sn):
        return mass_dt2[:, None] * sn - matvec(sn)

    def apply(c, sn, u_prev, ctx):
        u, _ = cg(c + ctx, u_prev)
        return sn + u, u

    return prep, apply
