"""Tensor-parallel reduced stepping: the hyper-reduced work of a prepared
``AnimSnapBasesSolver`` split over a mesh axis.

Counterpart of ``animsnapbases_tpu/parallel/reduced_tp.py``.  Of the fully
reduced iteration's three costs:

1. the selected elements' projections and the ``W @ p`` products are split
   on the selected-element axis: each rank holds its block of every
   group's subset data and ``W`` columns, and the partial rb is one (r, 3)
   ``all_reduce`` an iteration;
2. the displacement form's constant -U^T A_c s_n, a (3, r, N) by (N, 3)
   contraction, is split on the vertex axis (one ``all_reduce`` a step);
3. the lift q = s_n + U u is split on the same vertex axis, and the blocks
   are gathered through an ``all_reduce`` of a zero-padded buffer
   (``collectives.gather_blocks``).

The r x r solve and the update of the selected vertices run replicated.
The step is plain torch in the solver's dtype (no kernel: the JAX step is
plain XLA too), except two sums kept in float64: the selected elements'
projections with their ``W`` products, and U^T A_c s_n.  In float32 the
projections of q_sel, absolute positions (the bench cloth hangs 20 units
up), lose the low bits of its short edges, and the step lands ~6e-4 of
the scene's extent from the float64 step, where the single-process
float32 step (kernel 1's loop, on the gathered differences G s_n + UG u)
lands ~4e-7; the JAX step runs both in its working dtype.  Blocks are
those of ``collectives.block_range``; a padded element would add nothing
(a zero ``W`` column in the JAX package), so none is computed.
"""

from __future__ import annotations

import numpy as np
import torch

from animsnapbases_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    as_tensor,
    axis_of,
    block_range,
    gather_blocks,
)
from animsnapbases_tpu_torch.sim import projections
from animsnapbases_tpu_torch.sim.solver import device_data


def make_tp_reduced_step(solver, mesh, elem_axis: str = "model"):
    """``step(positions (N, 3), velocities, fext, num_iterations=10,
    targets=None) -> (q, v)`` with the prepared reduced solver's work split
    over ``mesh[elem_axis]``, replicated tensors on the solver's device in
    its dtype.  Needs position reduction and every constraint group
    hyper-reduced (``ValueError`` otherwise, as the JAX function raises).
    ``targets`` (e, 3) are the positional targets of this call (animated
    schedules), by default those of the solver's frame."""
    model = solver.model
    if not solver.reduced_position or solver.U is None:
        raise ValueError("TP reduced stepping needs position reduction")
    if any(name != "positional" and name not in solver._reduced_groups
           for name in model.groups):
        raise ValueError("TP reduced stepping needs every constraint group "
                         "hyper-reduced")
    group, size, index = axis_of(mesh, elem_axis)
    dev = solver.device
    dtype = solver.dtype

    def tensor(x):
        return as_tensor(x, dtype, dev)

    n = model.n_verts
    r = solver.U.shape[1]
    dt = solver.dt
    dtv, dt2 = dt * solver.eta, dt * dt
    floor, floor_h = model.floor_collision, model.floor_height
    mass = tensor(model.mass)

    union, remapped = solver._remapped_subsets()
    union_t = torch.as_tensor(union, device=dev)
    U_sel = tensor(solver.U[union])                      # (n_sel, r, 3)
    inv3 = tensor(solver._inv_np)                        # (3, r, r)
    vlo, vhi = block_range(n, size, index)
    U_l = tensor(solver.U[vlo:vhi])                      # (n_l, r, 3)
    # float64, as ops/resident.py's ``project`` accumulates (the module
    # docstring)
    utac_l = as_tensor(solver._ut_ac_np[:, :, vlo:vhi], torch.float64,
                       dev)                              # (3, r, n_l)

    pos_g = model.groups.get("positional")
    if pos_g is not None:
        ST = pos_g.assembly_scipy(n).toarray()
        utst = tensor(np.stack([solver.U[:, :, d].T @ ST
                                for d in range(3)]))     # (3, r, e_pos)
        targets0 = tensor(model.positional_targets(solver.frame))

        def rb_extra_of(targets):
            return torch.einsum("dre,ed->rd", utst, targets)
    else:
        targets0 = tensor(np.zeros((0, 3)))

        def rb_extra_of(targets):
            return torch.zeros((r, 3), dtype=dtype, device=dev)

    # each rank's block of every group's selected elements
    shards = []
    for name, rg in solver._reduced_groups.items():
        m, p = rg.num_selected, rg.p
        lo, hi = block_range(m, size, index)
        if hi <= lo:
            continue
        sub = {k: (np.asarray(v)[lo:hi] if isinstance(v, np.ndarray)
                   and v.ndim >= 1 and v.shape[0] == m else v)
               for k, v in remapped[name].items()}
        data = device_data(sub, dev, torch.float64)
        if rg.row_select is not None:
            # row form: W column i belongs to selected element i
            rows = (np.asarray(rg.row_select)[lo:hi]
                    - np.arange(lo, hi) * p + np.arange(hi - lo) * p)
            W = as_tensor(rg.W[:, :, lo:hi], torch.float64, dev)
            rows = torch.as_tensor(rows, device=dev)
        else:
            # block form: W columns come in whole p-blocks per element
            W = as_tensor(rg.W[:, :, lo * p:hi * p], torch.float64, dev)
            rows = None
        shards.append((name, data, W, rows))

    def step(positions, velocities, fext, num_iterations=10, targets=None):
        positions, velocities = tensor(positions), tensor(velocities)
        sn = positions + dtv * velocities + dt2 * (tensor(fext)
                                                   / mass[:, None])
        if floor:
            sn[:, 1] = torch.clamp(sn[:, 1], min=floor_h)
        t = targets0 if targets is None else tensor(targets)
        rb_const = -torch.einsum("drn,nd->rd", utac_l,
                                 sn[vlo:vhi].double())
        rb_const = (all_reduce_sum(rb_const, group).to(dtype)
                    + rb_extra_of(t))
        sn_sel = sn[union_t]
        q_sel = sn_sel
        u = torch.zeros((r, 3), dtype=dtype, device=dev)
        for _ in range(num_iterations):
            partial = torch.zeros((r, 3), dtype=torch.float64, device=dev)
            q_wide = q_sel.double()
            for name, data, W, rows in shards:
                pk = projections.PROJECTION_KERNELS[name](q_wide, data)
                if rows is not None:
                    pk = pk[rows]
                partial = partial + torch.einsum("dop,pd->od", W, pk)
            rb = rb_const + all_reduce_sum(partial, group).to(dtype)
            u = torch.einsum("drs,sd->rd", inv3, rb)
            q_sel = sn_sel + torch.einsum("nrd,rd->nd", U_sel, u)
        q_l = sn[vlo:vhi] + torch.einsum("nrd,rd->nd", U_l, u)
        q = gather_blocks(q_l, n, mesh, elem_axis)
        return q, (q - positions) / dt

    return step
