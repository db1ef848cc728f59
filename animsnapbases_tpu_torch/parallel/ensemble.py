"""Sharded full-order stepping over a ``torch.distributed`` device mesh.

Counterpart of ``animsnapbases_tpu/parallel/ensemble.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes
(:func:`build_device_mesh`) over the ranks of an initialized process
group, one rank per card under NCCL in production; every rank runs the
same program (SPMD).  Two strategies compose:

* :func:`make_ensemble_step`, data parallelism: each rank steps its slice
  of a batch of independent sims, with no collective;
* :func:`make_element_sharded_step`, one sim with every constraint
  group's elements split over an axis: each rank projects its elements
  and assembles its partial S^T p, the right-hand side is one
  ``all_reduce`` over the axis, and the global solve
  (``sim/solver.py::make_device_global_solve``: dense Cholesky below the
  size limit, device CG above it) runs replicated on every rank.

The collectives and the block rule are ``parallel/collectives.py``'s.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE, resolve_device
from animsnapbases_tpu_torch.ops import segment
from animsnapbases_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    as_tensor,
    axis_of,
    block_range,
)
from animsnapbases_tpu_torch.sim import projections
from animsnapbases_tpu_torch.sim.solver import (
    device_data,
    make_device_global_solve,
    make_local_stage,
)


def build_device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
                      device=None) -> DeviceMesh:
    """A mesh of the first prod(``shape``) ranks of the default process
    group, row-major, on ``device``'s type (default the card).  Raises
    ``RuntimeError`` without a process group and ``ValueError`` with too
    few ranks."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("build_device_mesh needs an initialized "
                           "torch.distributed process group")
    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, "
                         f"have {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def visible_ranks() -> int:
    """The ranks a mesh can take: the default process group's size, or 1
    without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_from_shards(shards: int, device=None):
    """A 1-D ("model",) mesh of ``shards`` ranks for the sharded bases
    compute, or None: for ``shards`` <= 1, and, with a warning, where fewer
    ranks exist (the caller stays on one device)."""
    shards = int(shards or 0)
    if shards <= 1:
        return None
    visible = visible_ranks()
    if visible < shards:
        warnings.warn(
            f"device_mesh_shards={shards} requested but only {visible} "
            f"devices are visible; bases compute stays single-device")
        return None
    return build_device_mesh((shards,), ("model",), device)


def _predictor(model, dt, eta, mass):
    """sn = q + dt*eta*v + dt^2 f / m, clamped above the floor."""
    dtv, dt2 = dt * eta, dt * dt
    floor, floor_h = model.floor_collision, model.floor_height

    def predict(positions, velocities, fext):
        sn = positions + dtv * velocities + dt2 * (fext / mass[:, None])
        if floor:
            sn = sn.clone()
            sn[:, 1] = torch.clamp(sn[:, 1], min=floor_h)
        return sn

    return predict


def _single_sim_step_core(model, dt, device=None, dtype=PIPELINE_DTYPE,
                          eta=1.0):
    """One full-order step of one sim on tensors:
    ``core(positions, velocities, fext, num_iterations=4, targets=None) ->
    (q, v)``, the positional targets of frame 0 unless ``targets`` are
    given, the solve of ``make_device_global_solve``."""
    dev = resolve_device(device)
    prep, apply = make_device_global_solve(model, dt, dev, dtype)
    local = make_local_stage(model, dev, dtype)
    mass = torch.as_tensor(model.mass, dtype=dtype, device=dev)
    targets0 = as_tensor(model.positional_targets(0), dtype, dev)
    predict = _predictor(model, dt, eta, mass)

    def core(positions, velocities, fext, num_iterations=4, targets=None):
        sn = predict(positions, velocities, fext)
        ctx = prep(sn)
        t = targets0 if targets is None else as_tensor(targets, dtype, dev)
        q, u = sn, torch.zeros_like(sn)
        for _ in range(num_iterations):
            b, _ = local(q, t)
            q, u = apply(b, sn, u, ctx)
        return q, (q - positions) / dt

    return core


def make_ensemble_step(model, dt, mesh, batch_axis: str = "data",
                       dtype=None, eta=1.0, device=None):
    """Data-parallel stepping of B independent sims over ``batch_axis``
    -> ``(step, shard)``: ``shard(x)`` is this rank's slice of a global
    (B, N, 3) array as a tensor (B a multiple of the axis size), and
    ``step(positions, velocities, fext, num_iterations=4)`` steps such
    slices, each sim on its own, with no collective."""
    _, size, index = axis_of(mesh, batch_axis)
    dev = resolve_device(device)
    dtype = PIPELINE_DTYPE if dtype is None else dtype
    core = _single_sim_step_core(model, dt, dev, dtype, eta)

    def step(positions, velocities, fext, num_iterations=4):
        out = [core(p, v, f, num_iterations)
               for p, v, f in zip(positions, velocities, fext)]
        return (torch.stack([q for q, _ in out]),
                torch.stack([v for _, v in out]))

    def shard(x):
        x = as_tensor(x, dtype, dev)
        if x.shape[0] % size:
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"{size} ranks")
        bl = x.shape[0] // size
        return x[index * bl:(index + 1) * bl]

    return step, shard


def make_element_sharded_step(model, dt, mesh, elem_axis: str = "model",
                              dtype=None, num_iterations: int = 4, eta=1.0,
                              device=None):
    """One sim with every constraint group's elements split over
    ``elem_axis`` -> ``step(positions (N, 3), velocities, fext,
    targets=None) -> (q, v)``, replicated tensors on every rank of the
    axis.  Each rank projects its block of each group's elements and sums
    its partial S^T p; the right-hand side is one ``all_reduce`` an
    iteration; the positional term (small) and the global solve run
    replicated.  ``targets`` (e, 3) are the positional targets of this call
    (animated schedules), by default those of frame 0."""
    group, size, index = axis_of(mesh, elem_axis)
    dev = resolve_device(device)
    dtype = PIPELINE_DTYPE if dtype is None else dtype
    n = model.n_verts
    prep, apply = make_device_global_solve(model, dt, dev, dtype)
    mass = torch.as_tensor(model.mass, dtype=dtype, device=dev)
    predict = _predictor(model, dt, eta, mass)

    def tensor(x):
        return as_tensor(x, dtype, dev)

    blocks, pos_layout = [], None
    for name, g in model.groups.items():
        if name == "positional":
            pos_layout = segment.row_layout(
                g.st_rows, g.st_cols, tensor(g.st_vals), n)
            continue
        lo, hi = block_range(g.num, size, index)
        if hi > lo:
            blocks.append((name,) + _element_shard(g, lo, hi, n, dev, dtype))
    targets0 = tensor(model.positional_targets(0)) if pos_layout else None

    def rhs(q):
        b = torch.zeros((n, 3), dtype=q.dtype, device=q.device)
        for name, data, layout in blocks:
            b = b + segment.row_sum(
                layout, projections.PROJECTION_KERNELS[name](q, data))
        return all_reduce_sum(b, group)

    def step(positions, velocities, fext, targets=None):
        positions, velocities = tensor(positions), tensor(velocities)
        sn = predict(positions, velocities, tensor(fext))
        ctx = prep(sn)
        b_pos = None
        if pos_layout is not None:
            t = targets0 if targets is None else tensor(targets)
            b_pos = segment.row_sum(pos_layout, projections.positional_p(t))
        q, u = sn, torch.zeros_like(sn)
        for _ in range(num_iterations):
            b = rhs(q)
            if b_pos is not None:
                b = b + b_pos
            q, u = apply(b, sn, u, ctx)
        return q, (q - positions) / dt

    return step


def _element_shard(g, lo: int, hi: int, n: int, device, dtype):
    """Group ``g``'s elements [lo, hi): their data on the device, and the
    S^T columns they own in the fixed-order row layout of
    ``ops/segment.py`` over the model's ``n`` vertices."""
    e, p = g.num, g.p
    data = {k: (v[lo:hi] if isinstance(v, np.ndarray) and v.dtype != object
                and v.shape[:1] == (e,) else v)
            for k, v in g.data.items()}
    cols = np.asarray(g.st_cols)
    mine = (cols >= lo * p) & (cols < hi * p)
    layout = segment.row_layout(
        np.asarray(g.st_rows)[mine], cols[mine] - lo * p,
        torch.as_tensor(np.asarray(g.st_vals)[mine], dtype=dtype,
                        device=device), n)
    return device_data(data, device, dtype), layout
