"""Differentiable reduced-PD stepping and rollouts on ``torch.autograd``.

Counterpart of ``animsnapbases_tpu/sim/diff.py``: the reduced step of a
fully reduced solver (position reduction on, every group other than
``positional`` constraint-reduced) as a pure function of the state, the
external force, the positional targets and a per-group scale of the
constraint weights, so that gradients flow through whole rollouts with
respect to

* the per-group weight scales (material identification: every group's
  S^T triplets and LHS triplets are linear in its ``wi``, so a scalar per
  group scales its precomputed reduced operators exactly),
* the external forces, the positional targets and the initial state.

The forward math is the solver's displacement form (``sim/reduced.py``
``prepare_global_matrix``): ``q = s_n + U u`` with the r x r systems per
dimension

    Ar_d(s) = U_d^T (M/dt^2) U_d + sum_g s_g U_d^T A_g,d U_d

rebuilt from the per-group pieces each step (scaled sums of (r, r) and
(r, N) operands), and ``torch.linalg.solve`` in place of the solver's
precomputed inverse, so that gradients flow through the left-hand side
too.  The local step runs the port's ``PROJECTION_KERNELS`` (the Jacobi
small SVDs of ``ops/svd3.py``, as the JAX package does) on the selected
vertices.  It is plain PyTorch: no kernel of the port has a backward, and
this path runs none of them.

Every operand is float64 (``device.PIPELINE_DTYPE``) on the solver's
device, the card or the CPU, whatever the solver's working dtype: with
pinned vertices ``Ar`` carries 1e10/dt^2 mass terms (condition ~1e9-1e10),
where float32 solves give wrong gradients.  (The JAX class casts to the
solver's dtype and warns about float32; the port's full-space solves run
float64 on the card too.)

For offline fitting and design loops, not the serving path: the
self-collision pass is not applied.  With ``checkpoint`` each step of a
rollout is recomputed in the backward pass
(``torch.utils.checkpoint``), which keeps reverse-mode memory at
O(T * state) whatever the number of iterations.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import scipy.sparse
import torch
import torch.utils.checkpoint

from animsnapbases_tpu_torch.device import PIPELINE_DTYPE
from animsnapbases_tpu_torch.sim import projections
from animsnapbases_tpu_torch.sim.solver import group_dim_triplets

__all__ = ["DiffReducedSim", "fit_scales"]


def _group_dim_block(g, n: int) -> scipy.sparse.csr_matrix:
    """One group's per-dimension (N, N) LHS block
    (:func:`~animsnapbases_tpu_torch.sim.solver.group_dim_triplets`)."""
    rows, cols, vals = group_dim_triplets(g)
    return scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))


class DiffReducedSim:
    """Pure-function view of a prepared fully reduced
    :class:`~animsnapbases_tpu_torch.sim.reduced.AnimSnapBasesSolver`.

    The solver is only read at construction; stepping never changes it.
    ``scales`` is a (n_groups,) tensor of per-group weight multipliers in
    the order of :attr:`group_names`; ones reproduce the solver's own
    dynamics (up to the solve against its precomputed inverse)."""

    def __init__(self, solver):
        if not getattr(solver, "reduced_position", False):
            raise ValueError("DiffReducedSim needs position reduction")
        if solver.U is None or getattr(solver, "_inv_np", None) is None:
            raise ValueError("solver must be prepared() first")
        model = solver.model
        full = [name for name in model.groups
                if name not in solver._reduced_groups]
        if set(full) - {"positional"}:
            raise ValueError(
                "DiffReducedSim needs the fully-reduced fast path; "
                f"non-reduced groups present: {sorted(set(full))}")

        self.device = solver.device
        self.dtype = PIPELINE_DTYPE
        self.dt = float(solver.dt)
        self.eta = float(getattr(solver, "eta", 1.0))
        self.floor = bool(model.floor_collision)
        self.floor_height = float(model.floor_height)
        self.n_verts = n = model.n_verts
        dt2 = self.dt * self.dt

        U = np.asarray(solver.U, dtype=np.float64)      # (N, r, 3)
        self.r = U.shape[1]

        # the per-group reduced LHS pieces (linear in the weights)
        self.group_names = list(model.groups)
        G_list, utac_list = [], []
        for name in self.group_names:
            A_g = _group_dim_block(model.groups[name], n)
            G_list.append(np.stack(
                [U[:, :, d].T @ (A_g @ U[:, :, d]) for d in range(3)]))
            utac_list.append(np.stack(
                [(A_g.T @ U[:, :, d]).T for d in range(3)]))

        # the reduced groups' right-hand sides, as the solver's step has them
        union, remapped = solver._remapped_subsets()
        self._reduced = []
        for name, rg in solver._reduced_groups.items():
            data = {k: (self.tensor(v) if np.issubdtype(v.dtype, np.floating)
                        else torch.as_tensor(v, device=self.device))
                    if isinstance(v, np.ndarray) else v
                    for k, v in remapped[name].items()}
            rs = (torch.as_tensor(rg.row_select, device=self.device)
                  if rg.row_select is not None else None)
            self._reduced.append((name, self.group_names.index(name), data,
                                  self.tensor(rg.W), rs))

        uts = solver._ut_st_np()
        self._has_targets = uts is not None
        self._i_pos = (self.group_names.index("positional")
                       if "positional" in self.group_names else None)
        self.n_targets = (model.groups["positional"].num
                          if self._i_pos is not None else 0)

        self.U = self.tensor(U)
        self.U_sel = self.tensor(U[union])                  # (n_sel, r, 3)
        self.union = torch.as_tensor(union, device=self.device)
        self.mass = self.tensor(model.mass)
        self.mass_r = self.tensor(np.stack(
            [U[:, :, d].T @ ((model.mass / dt2)[:, None] * U[:, :, d])
             for d in range(3)]))                           # (3, r, r)
        self.G = self.tensor(np.stack(G_list))              # (g, 3, r, r)
        self.ut_ac = self.tensor(np.stack(utac_list))       # (g, 3, r, N)
        self.UtSt = (self.tensor(uts) if uts is not None
                     else self.tensor(np.zeros((3, self.r, 0))))

    def tensor(self, x):
        """``x`` as a float64 tensor on the sim's device (a tensor of that
        dtype and device as it is, its graph kept)."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- pure stepping -------------------------------------------------

    def _step(self, q, v, fext, targets, scales, num_iterations=10):
        dt, dt2 = self.dt, self.dt * self.dt
        sn = q + (dt * self.eta) * v + dt2 * (fext / self.mass[:, None])
        if self.floor:
            sn = torch.cat([sn[:, :1],
                            projections.floor_at(sn[:, 1:2],
                                                 self.floor_height),
                            sn[:, 2:]], dim=1)

        # the weight-dependent operators: scaled sums of the group pieces
        Ar = self.mass_r + torch.einsum("g,gdrs->drs", scales, self.G)
        ut_ac = torch.einsum("g,gdrn->drn", scales, self.ut_ac)

        # the displacement form: the pinned-mass predictor terms cancel
        rb_const = -torch.einsum("drn,nd->rd", ut_ac, sn)
        if self._has_targets:
            rb_const = rb_const + scales[self._i_pos] * torch.stack(
                [self.UtSt[d] @ targets[:, d] for d in range(3)], dim=1)

        sn_sel = sn[self.union]
        q_sel = sn_sel
        u = torch.zeros((self.r, 3), dtype=sn.dtype, device=sn.device)
        for _ in range(num_iterations):
            rb = rb_const
            for name, gi, data, W, rs in self._reduced:
                p = projections.PROJECTION_KERNELS[name](q_sel, data)
                if rs is not None:
                    p = p[rs]
                rb = rb + scales[gi] * torch.einsum("dop,pd->od", W, p)
            # (3, r, r) x (3, r, 1): differentiable in Ar and rb; without
            # the check of torch.linalg.solve, which waits for the card (a
            # singular Ar gives non-finite values, as jnp.linalg.solve does)
            u = torch.linalg.solve_ex(Ar, rb.T[:, :, None],
                                      check_errors=False)[0][:, :, 0].T
            q_sel = sn_sel + torch.einsum("nrd,rd->nd", self.U_sel, u)
        q_new = sn + torch.einsum("nrd,rd->nd", self.U, u)
        return q_new, (q_new - q) / dt

    def step(self, q, v, fext, targets, scales, num_iterations=10):
        """One reduced step -> (q', v'), a pure function of its tensors:
        gradients flow to ``q``, ``v``, ``fext``, ``targets`` (e_pos, 3)
        and ``scales`` (through the solve of ``Ar``)."""
        t = self.tensor
        return self._step(t(q), t(v), t(fext), t(targets), t(scales),
                          num_iterations)

    def ones_scales(self):
        return torch.ones(len(self.group_names), dtype=self.dtype,
                          device=self.device)

    # -- rollouts --------------------------------------------------------

    def make_rollout(self, num_steps: int, num_iterations: int = 10,
                     save_trajectory: bool = False,
                     checkpoint: bool = True):
        """``rollout(q0, v0, fext, targets_seq, scales) -> (qT, vT[,
        traj])`` over ``num_steps`` steps.

        ``targets_seq`` is a (T, e_pos, 3) timeline of positional targets
        (T = 1 for static targets); step i reads row min(i, T - 1), as
        ``run_steps`` does.  ``traj`` (num_steps, N, 3) holds the positions
        after each step.  With ``checkpoint`` (default) each step is
        recomputed in the backward pass."""
        def one(q, v, fext, targets, scales):
            if checkpoint:
                return torch.utils.checkpoint.checkpoint(
                    self._step, q, v, fext, targets, scales, num_iterations,
                    use_reentrant=False, preserve_rng_state=False)
            return self._step(q, v, fext, targets, scales, num_iterations)

        def rollout(q0, v0, fext, targets_seq, scales):
            t = self.tensor
            q, v, fext, targets_seq, scales = (
                t(x) for x in (q0, v0, fext, targets_seq, scales))
            T = targets_seq.shape[0]
            traj = []
            for i in range(num_steps):
                q, v = one(q, v, fext, targets_seq[min(i, T - 1)], scales)
                traj.append(q)
            if not save_trajectory:
                return q, v
            return q, v, (torch.stack(traj) if traj
                          else q.new_zeros((0,) + tuple(q.shape)))

        return rollout


# Adam steps fit_scales runs eagerly on the card before it captures one
# step in a CUDA graph (the warm-up a capture needs)
EAGER_STEPS = 2


def fit_scales(sim: DiffReducedSim, q0, v0, fext, targets_seq, target_traj,
               scales0=None, num_steps: int | None = None,
               num_iterations: int = 10, steps: int = 100,
               learning_rate: float = 0.05, log_every: int = 0):
    """Recover per-group weight scales by gradient descent on a recorded
    trajectory (system identification).

    Optimizes ``log(scales)`` (positivity) with Adam (``torch.optim.Adam``
    with optax's defaults: betas (0.9, 0.999), eps 1e-8) against the mean
    squared position error over ``target_traj`` (T', N, 3).  Returns
    ``(scales, loss_history)``: ``history[i]`` is the loss of the i-th
    iterate, and one final evaluation is appended, so that ``history[-1]``
    is the loss of the returned scales.

    On the card, an Adam step is thousands of small kernels, each costing
    more to launch from Python than to run: after EAGER_STEPS eager steps
    (on a side stream, the warm-up of a capture) one step (rollout, loss,
    backward and update) is captured in a CUDA graph and replayed for the
    others.  The same kernels run in the same order."""
    t = sim.tensor
    q0, v0, fext, targets_seq = (t(x) for x in (q0, v0, fext, targets_seq))
    target = t(target_traj)
    num_steps = int(target.shape[0] if num_steps is None else num_steps)
    rollout = sim.make_rollout(num_steps, num_iterations,
                               save_trajectory=True)
    log_s = torch.log(t(sim.ones_scales() if scales0 is None else scales0))
    log_s = log_s.detach().clone().requires_grad_(True)
    cuda = log_s.is_cuda

    def loss_fn():
        _, _, traj = rollout(q0, v0, fext, targets_seq, torch.exp(log_s))
        return torch.mean((traj - target) ** 2)

    opt = torch.optim.Adam([log_s], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8, capturable=cuda)

    def adam_step():
        loss = loss_fn()
        loss.backward()
        opt.step()
        return loss.detach()

    history = []

    def note(loss):
        history.append(float(loss))
        i = len(history) - 1
        if log_every and i % log_every == 0:
            print(f"  fit step {i:4d}  loss {history[-1]:.3e}  scales "
                  f"{np.exp(log_s.detach().cpu().numpy()).round(4)}",
                  file=sys.stderr)

    eager = min(steps, EAGER_STEPS) if cuda else steps
    side = torch.cuda.Stream(device=log_s.device) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(log_s.device))
    with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
        for _ in range(eager):
            opt.zero_grad(set_to_none=True)
            note(adam_step())
    if cuda:
        torch.cuda.current_stream(log_s.device).wait_stream(side)
    if eager < steps:
        graph = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            loss = adam_step()
        for _ in range(eager, steps):
            graph.replay()
            note(loss)
    with torch.no_grad():
        history.append(float(loss_fn()))
    return torch.exp(log_s.detach()), history
