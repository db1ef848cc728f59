"""Differentiable reduced rollouts of the PyTorch port
(``animsnapbases_tpu_torch.sim.diff``) against the JAX package's
``animsnapbases_tpu.sim.diff``, float64 on the CPU, each package's solver
prepared from the same bases files (the fixtures of ``tests/test_diff.py``:
the 5x5 cloth of ``test_sim_reduced_position``, the 4x3x3 tet bar and the
bending cloth of ``test_pallas_all_groups``).

Tolerances, each beside the gap measured on a CPU: the forward step
after 8 steps 1e-10 of the extent against JAX (measured 3.8e-11) and 1e-8
against the port solver's own ``step()`` (the JAX test's rule; measured
1.5e-10); gradients 1e-8 relative to the largest entry (measured 3.6e-9 on
the scales), except where the pinned Ar's condition bounds what two LU
factorizations can agree on (the targets 5e-8, the tet bar 1e-4: see
their constants); the Adam fit's scales 1e-8 relative and its losses
1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animsnapbases_tpu.sim.diff import DiffReducedSim as JaxDiff
from animsnapbases_tpu.sim.diff import fit_scales as jax_fit_scales
from animsnapbases_tpu_torch.config.sim_config import default_sim_args
from animsnapbases_tpu_torch.geometry.procedural import bar_model, cloth_model
from animsnapbases_tpu_torch.sim.diff import DiffReducedSim, fit_scales
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import (
    GROUP_ARG_NAMES,
    AnimSnapBasesSolver,
)
from test_sim_reduced_position import _reduced_solver, pipeline  # noqa: F401
from test_sim_solver import gravity_forces
from test_torch_block_bases import one_thread  # noqa: F401

STEP_TOL = 1e-10      # of the extent, against JAX
SOLVER_TOL = 1e-8     # of the extent, against the port solver's step()
GRAD_TOL = 1e-8       # relative to the largest entry
# the targets' gradient on the pinned bending cloth: its entries (~1e-9)
# are what is left of the pins' 1e5 and 1e10 terms, through solves of Ar
# (condition ~1e10), so two LU factorizations part by ~cond * eps relative
# to them (measured 1.4e-8 against jax.grad; 1.3e-9 between JAX's own
# checkpointed and plain backward)
TARGET_GRAD_TOL = 5e-8
# the tet bar's gradients: its Ar has condition 1.1e16 in y (6.9e8 and
# 2.9e8 in x and z), so the two LU factorizations part by ~1e-5 relative
# (measured 6.1e-6 on the force multiplier, 2.3e-5 on the scales; 2.1e-7
# already after one step of one iteration)
BAR_GRAD_TOL = 1e-4


def port_args(basis_dir, pos_path, groups, modes, r, oversample=1.0,
              position=True):
    args = default_sim_args()
    args.dt = 0.016
    args.constraint_projection_basis_type = "deim_pod_vectorized"
    args.geom_interpolation_basis_dir = basis_dir
    args.geom_interpolation_basis_file = "basis.npz"
    args.position_reduced = position
    args.position_num_components = r
    args.position_basis_file = pos_path
    args.deim_oversample = oversample
    for g in groups:
        flag, num = GROUP_ARG_NAMES[g]
        setattr(args, flag, True)
        setattr(args, num, modes)
    return args


def port_solver(make_model, args):
    solver = AnimSnapBasesSolver(args, device="cpu")
    model = make_model()
    solver.set_model(model)
    solver.prepare(args)
    return solver, model


def port_cloth():
    """``test_sim_solver.make_cloth_solver(rows=5, cols=5, wi=1e4,
    tilt=0.15)``'s model, built with the port's classes."""
    V, F = cloth_model(5, 5)
    V = V.copy()
    V[:, 2] += 0.15 * V[:, 0]
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=3.0)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    return model


def port_bar():
    """``test_pallas_all_groups._make_bar_model`` with the port's
    classes."""
    V, T, F, _ = bar_model(4, 3, 3)
    model = DeformableModel(V, F, elements=T, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=1.0)
    model.add_tet_constrain_strain(0.95, 1.05, wi=1e5)
    model.add_tet_constrain_deformation_gradient(wi=1e5)
    model.fix_side_vertices(side="left", threshold=0.5, axis=0)
    return model


def port_bend_cloth():
    """``test_pallas_all_groups._make_bend_cloth_model`` with two
    positional pins (``tests/test_diff.py`` ``bend_diff``), with the port's
    classes."""
    V, F = cloth_model(6, 6)
    V = V.copy()
    V[:, 2] += 0.2 * np.sin(V[:, 0])
    model = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                            floor_collision=True, init_height_shift=3.0)
    model.add_vertex_bending_constraint(wi=50.0)
    model.add_edge_spring_constraint(wi=1e4)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.compute_cloth_corner_indices()
    model.fix_surface_side_vertices("left")
    model.add_positional_constraint(0, wi=1e5)
    model.add_positional_constraint(5, wi=1e5)
    return model


class Pair:
    """The JAX and the port view of one scene, and its inputs (numpy)."""

    def __init__(self, jax_solver, jax_model, solver, model, fext):
        self.jax_solver, self.solver = jax_solver, solver
        self.jax = JaxDiff(jax_solver)
        self.port = DiffReducedSim(solver)
        assert self.port.group_names == self.jax.group_names
        np.testing.assert_array_equal(model.positions, jax_model.positions)
        self.model = model
        self.q0 = model.positions.copy()
        self.v0 = model.velocities.copy()
        self.fext = fext
        self.targets = model.positional_targets(0)[None]


@pytest.fixture(scope="module")
def cloth(pipeline):  # noqa: F811
    basis_dir, pos_path, _ = pipeline
    js, jm = _reduced_solver(basis_dir, pos_path, with_position=True)
    s, m = port_solver(port_cloth, port_args(
        basis_dir, pos_path, ("tris_strain", "edge_spring"), 10, 14))
    return Pair(js, jm, s, m, gravity_forces(m))


@pytest.fixture(scope="module")
def bar(tmp_path_factory):
    from reduction_helpers import record_and_build_bases
    from test_pallas_all_groups import _make_bar_model, _reduced
    from test_sim_solver import sim_args

    tmp = tmp_path_factory.mktemp("bar_diff")
    basis_dir, pos_path, _ = record_and_build_bases(
        tmp, _make_bar_model, sim_args())
    groups = ("tets_strain", "tets_deformation_gradient")
    js, jm = _reduced(_make_bar_model, basis_dir, pos_path, "off", groups,
                      oversample=1.5)
    s, m = port_solver(port_bar, port_args(basis_dir, pos_path, groups, 8,
                                           16, oversample=1.5))
    f = np.zeros_like(m.positions)
    f[:, 1] = -98.1
    return Pair(js, jm, s, m, f)


@pytest.fixture(scope="module")
def bend(tmp_path_factory):
    from reduction_helpers import record_and_build_bases
    from test_pallas_all_groups import _make_bend_cloth_model, _reduced
    from test_sim_solver import sim_args

    def make_pinned():
        model = _make_bend_cloth_model()
        model.add_positional_constraint(0, wi=1e5)
        model.add_positional_constraint(5, wi=1e5)
        return model

    tmp = tmp_path_factory.mktemp("bend_diff")
    basis_dir, pos_path, _ = record_and_build_bases(tmp, make_pinned,
                                                    sim_args())
    groups = ("verts_bending", "edge_spring", "tris_strain")
    js, jm = _reduced(make_pinned, basis_dir, pos_path, "off", groups)
    s, m = port_solver(port_bend_cloth, port_args(basis_dir, pos_path,
                                                  groups, 8, 16))
    f = np.zeros_like(m.positions)
    f[:, 1] = -98.1
    return Pair(js, jm, s, m, f)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_step_matches_jax_and_the_solver(cloth):
    """8 steps at ones scales: within STEP_TOL of the extent of JAX's
    (measured 3.8e-11; velocities within STEP_TOL / dt, measured 8.4e-10)
    and within SOLVER_TOL of the port solver's own ``step()`` (measured
    1.5e-10); velocities within 1e-6 of the extent, as the JAX test holds
    them."""
    jd, pd = cloth.jax, cloth.port
    qj, vj = jnp.asarray(cloth.q0), jnp.asarray(cloth.v0)
    qt, vt = torch.tensor(cloth.q0), torch.tensor(cloth.v0)
    for _ in range(8):
        qj, vj = jd.step(qj, vj, jnp.asarray(cloth.fext),
                         jnp.asarray(cloth.targets[0]), jd.ones_scales(),
                         num_iterations=6)
        qt, vt = pd.step(qt, vt, cloth.fext, cloth.targets[0],
                         pd.ones_scales(), num_iterations=6)
    scale = np.abs(np.asarray(qj)).max()
    assert np.abs(qt.numpy() - np.asarray(qj)).max() / scale < STEP_TOL
    assert np.abs(vt.numpy() - np.asarray(vj)).max() / scale < STEP_TOL / 0.016
    model = cloth.model
    model.positions, model.velocities = cloth.q0.copy(), cloth.v0.copy()
    for _ in range(8):
        cloth.solver.step(cloth.fext, num_iterations=6)
    assert (np.abs(qt.numpy() - model.positions).max() / scale
            < SOLVER_TOL)
    np.testing.assert_allclose(vt.numpy(), model.velocities, rtol=0,
                               atol=1e-6 * scale)
    model.positions, model.velocities = cloth.q0.copy(), cloth.v0.copy()


def _loss_q(q, q0):
    return ((q - q0) ** 2).mean()


def jax_grad(pair, wrt, steps, iters, goal=None):
    """jax.grad of a rollout's loss with respect to ``wrt``: "scales" (mean
    (q - q0)^2), "force" (a multiplier of fext; mean q^2) or "targets"
    (mean (q - goal)^2)."""
    jd = pair.jax
    run = jd.make_rollout(num_steps=steps, num_iterations=iters)
    q0, v0 = jnp.asarray(pair.q0), jnp.asarray(pair.v0)
    f, t0 = jnp.asarray(pair.fext), jnp.asarray(pair.targets)
    ones = jd.ones_scales()
    loss = {
        "scales": lambda s: jnp.mean((run(q0, v0, f, t0, s)[0] - q0) ** 2),
        "force": lambda c: jnp.mean(run(q0, v0, c * f, t0, ones)[0] ** 2),
        "targets": lambda t: jnp.mean(
            (run(q0, v0, f, t, ones)[0] - jnp.asarray(goal)) ** 2),
    }[wrt]
    x = {"scales": ones, "force": jnp.asarray(1.0), "targets": t0}[wrt]
    return np.asarray(jax.grad(loss)(x))


def port_loss(pair, wrt, steps, iters, goal=None, checkpoint=True):
    pd = pair.port
    run = pd.make_rollout(num_steps=steps, num_iterations=iters,
                          checkpoint=checkpoint)
    q0 = torch.tensor(pair.q0)
    ones = pd.ones_scales()
    f, t0 = torch.tensor(pair.fext), torch.tensor(pair.targets)
    return {
        "scales": lambda s: _loss_q(run(q0, pair.v0, f, t0, s)[0], q0),
        "force": lambda c: (run(q0, pair.v0, c * f, t0, ones)[0] ** 2).mean(),
        "targets": lambda t: _loss_q(run(q0, pair.v0, f, t, ones)[0],
                                     torch.tensor(goal)),
    }[wrt], {"scales": ones, "force": torch.tensor(1.0, dtype=torch.float64),
             "targets": t0}[wrt]


def port_grad(pair, wrt, steps, iters, goal=None, checkpoint=True):
    loss, x = port_loss(pair, wrt, steps, iters, goal, checkpoint)
    x = x.clone().requires_grad_(True)
    loss(x).backward()
    return x.grad.numpy()


@pytest.mark.parametrize("wrt", ["scales", "force"])
def test_rollout_gradients_match_jax(cloth, wrt):
    """A 5-step rollout at 4 iterations: the gradient with respect to the
    scales (measured 3.6e-9 relative) and to a force multiplier (measured
    7.7e-11) within GRAD_TOL of ``jax.grad``; the scales' also against
    central differences at eps 1e-4 within the JAX test's 5e-3."""
    g = port_grad(cloth, wrt, 5, 4)
    gj = jax_grad(cloth, wrt, 5, 4)
    assert np.isfinite(g).all()
    assert rel(g, gj) < GRAD_TOL, (g, gj)
    if wrt == "scales":
        loss, s0 = port_loss(cloth, "scales", 5, 4)
        eps = 1e-4
        with torch.no_grad():
            for i in range(len(s0)):
                e = torch.zeros_like(s0)
                e[i] = eps
                fd = float(loss(s0 + e) - loss(s0 - e)) / (2 * eps)
                assert abs(g[i] - fd) / max(abs(fd), abs(g[i])) < 5e-3


def test_grad_wrt_positional_targets_matches_jax(bend):
    """Through the positional-target term (UtSt) and the bending, spring
    and strain projections: the gradient with respect to the (1, 2, 3)
    targets within TARGET_GRAD_TOL of ``jax.grad`` (measured 1.4e-8)."""
    assert bend.port._has_targets and bend.port.n_targets == 2
    goal = bend.q0 + 0.05
    g = port_grad(bend, "targets", 4, 4, goal)
    gj = jax_grad(bend, "targets", 4, 4, goal)
    assert g.shape == bend.targets.shape and np.isfinite(g).all()
    assert rel(g, gj) < TARGET_GRAD_TOL, (g, gj)


def test_grad_through_tet_kernels_at_rest(bar):
    """The bar starts exactly at rest (F = I in every tet: the 3x3 Jacobi
    sees a degenerate spectrum).  The gradients of a 3-step rollout's loss
    with respect to a force multiplier and to the scales (one backward, one
    ``jax.grad`` over both) are finite and equal JAX's within BAR_GRAD_TOL.
    This needs the Jacobi rotations out of place (``ops/svd3.py``
    ``_apply_jacobi``: written in place, autograd under the checkpoint's
    recomputation read the rotated values and returned 1.2e65)."""
    jd, pd = bar.jax, bar.port
    run_j = jd.make_rollout(num_steps=3, num_iterations=4)
    q0, v0 = jnp.asarray(bar.q0), jnp.asarray(bar.v0)
    f, t0 = jnp.asarray(bar.fext), jnp.asarray(bar.targets)
    gj = jax.grad(lambda c, s_: jnp.mean(run_j(q0, v0, c * f, t0, s_)[0]
                                         ** 2), argnums=(0, 1))(
        jnp.asarray(1.0), jd.ones_scales())
    run = pd.make_rollout(num_steps=3, num_iterations=4)
    c = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    scales = pd.ones_scales().requires_grad_(True)
    q = run(bar.q0, bar.v0, c * torch.tensor(bar.fext), bar.targets,
            scales)[0]
    (q ** 2).mean().backward()
    for g, gj_ in ((c.grad, gj[0]), (scales.grad, gj[1])):
        assert bool(torch.isfinite(g).all())
        assert rel(g, gj_) < BAR_GRAD_TOL, (g, gj_)


def test_checkpoint_matches_plain_backward(cloth):
    """The recomputed backward equals the plain one: the same operations in
    the same order (held at 1e-12 relative; measured 0)."""
    on = port_grad(cloth, "scales", 4, 3, checkpoint=True)
    off = port_grad(cloth, "scales", 4, 3, checkpoint=False)
    assert rel(on, off) < 1e-12


def test_vmapped_rollout_over_scales(cloth):
    """``torch.func.vmap`` of a rollout (checkpoint off) over three scale
    vectors matches the rollouts one by one (1e-10 relative; measured 0),
    and
    ``vmap(grad)`` gives finite per-candidate gradients."""
    pd = cloth.port
    run = pd.make_rollout(num_steps=4, num_iterations=3, checkpoint=False)
    q0, f = torch.tensor(cloth.q0), torch.tensor(cloth.fext)
    v0, t0 = torch.tensor(cloth.v0), torch.tensor(cloth.targets)
    batch = torch.stack([pd.ones_scales(), 0.7 * pd.ones_scales(),
                         1.3 * pd.ones_scales()])
    qb, vb = torch.func.vmap(lambda s: run(q0, v0, f, t0, s))(batch)
    assert qb.shape == (3,) + q0.shape
    for i in range(3):
        qi, vi = run(q0, v0, f, t0, batch[i])
        assert rel(qb[i], qi) < 1e-10 and rel(vb[i], vi) < 1e-10
    g = torch.func.vmap(torch.func.grad(
        lambda s: (run(q0, v0, f, t0, s)[0] ** 2).mean()))(batch)
    assert torch.isfinite(g).all()


def test_refuses_what_it_cannot_differentiate(pipeline):  # noqa: F811
    """The three refusals of the JAX class, with its messages: no position
    reduction, an unprepared solver, a non-positional group left full."""
    basis_dir, pos_path, _ = pipeline
    both = ("tris_strain", "edge_spring")
    s, _ = port_solver(port_cloth, port_args(basis_dir, pos_path, both, 10,
                                             14, position=False))
    with pytest.raises(ValueError, match="needs position reduction"):
        DiffReducedSim(s)
    args = port_args(basis_dir, pos_path, both, 10, 14)
    s = AnimSnapBasesSolver(args, device="cpu")
    s.set_model(port_cloth())
    with pytest.raises(ValueError, match="prepared"):
        DiffReducedSim(s)
    s, _ = port_solver(port_cloth, port_args(basis_dir, pos_path,
                                             ("tris_strain",), 10, 14))
    with pytest.raises(ValueError, match="non-reduced groups present: "
                       r"\['edge_spring'\]"):
        DiffReducedSim(s)


def test_fit_scales_matches_jax_optax(cloth):
    """Five Adam steps of ``fit_scales`` on a 6-step trajectory made with
    scales (0.55, 1.6) against the JAX ``fit_scales`` (optax's Adam): the
    fitted scales within 1e-8 relative (measured 8.8e-10), the loss
    histories (the five iterates and the final evaluation) within 1e-6
    relative (measured 1.8e-7, at the last).  A loss is the mean square of
    the gap between two trajectories, ~1e-4 of the positions by the fifth
    iterate, so the forward's ~1e-11 relative gap from JAX (the two LU
    factorizations of the pinned Ar) reaches it magnified: the port's loss
    at JAX's own fitted scales lies 1.75e-7 from JAX's."""
    jd, pd = cloth.jax, cloth.port
    true = np.array([0.55, 1.6])
    run = pd.make_rollout(6, num_iterations=4, save_trajectory=True)
    _, _, traj = run(cloth.q0, cloth.v0, cloth.fext, cloth.targets, true)
    args = dict(num_iterations=4, steps=5, learning_rate=0.08)
    s, hist = fit_scales(pd, cloth.q0, cloth.v0, cloth.fext, cloth.targets,
                         traj, **args)
    sj, hist_j = jax_fit_scales(
        jd, jnp.asarray(cloth.q0), jnp.asarray(cloth.v0),
        jnp.asarray(cloth.fext), jnp.asarray(cloth.targets),
        jnp.asarray(traj.numpy()), **args)
    assert len(hist) == len(hist_j) == 6
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-8, atol=0)
    np.testing.assert_allclose(hist, hist_j, rtol=1e-6, atol=0)
    assert hist[-1] < hist[0]






@pytest.mark.parametrize("where", ["floor", "tets_strain"])
def test_gradient_at_a_tie_is_jax(cloth, bar, where):
    """Where a clamp ties, JAX's ``jnp.maximum`` / ``jnp.clip`` pass half
    the cotangent to each side; the port's ``floor_at`` / ``clip`` do too
    (``torch.clamp`` would pass all of it).  "floor": one step (2
    iterations) from the cloth after 6 steps, set down so that its lowest
    vertex rests exactly on the floor with no velocity and no force, so its
    predictor ties the floor; the
    gradient of a fixed random functional of (q', v') with respect to q0
    against ``jax.grad`` of the JAX step, within GRAD_TOL (measured
    1.3e-9).  "tets_strain":
    the bar at rest, where F = I exactly, with the strain limits moved to
    [1, 1.05] so that every singular value ties the lower limit; the
    projection's gradient against JAX's to 1e-12 relative (measured 0)."""
    rng = np.random.default_rng(3)
    if where == "floor":
        jd, pd = cloth.jax, cloth.port
        # a deformed state (at rest, the strain projections' small SVDs are
        # degenerate and their gradients follow rounding), set down on the
        # floor
        run = pd.make_rollout(6, num_iterations=4, checkpoint=False)
        with torch.no_grad():
            q0 = run(cloth.q0, cloth.v0, cloth.fext, cloth.targets,
                     pd.ones_scales())[0].numpy()
        q0[:, 1] += pd.floor_height - q0[:, 1].min()
        low = int(np.argmin(q0[:, 1]))
        assert q0[low, 1] == pd.floor_height
        f = cloth.fext.copy()
        f[low] = 0.0
        v0 = np.zeros_like(q0)
        W = rng.standard_normal(q0.shape)

        def jax_loss(q):
            qn, vn = jd.step(q, jnp.asarray(v0), jnp.asarray(f),
                             jnp.asarray(cloth.targets[0]), jd.ones_scales(),
                             num_iterations=2)
            return jnp.sum((qn + 0.01 * vn) * W)

        gj = np.asarray(jax.grad(jax_loss)(jnp.asarray(q0)))
        q = torch.tensor(q0, requires_grad=True)
        qn, vn = pd.step(q, v0, f, cloth.targets[0], pd.ones_scales(),
                         num_iterations=2)
        ((qn + 0.01 * vn) * torch.tensor(W)).sum().backward()
        assert rel(q.grad, gj) < GRAD_TOL
        return
    from animsnapbases_tpu.sim import projections as jax_projections
    from animsnapbases_tpu_torch.ops.svd3 import svd3x3
    from animsnapbases_tpu_torch.sim import projections

    union, remapped = bar.solver._remapped_subsets()
    _, remapped_j = bar.jax_solver._remapped_subsets()
    data = dict(remapped["tets_strain"], sigma_min=1.0)
    data_j = dict(remapped_j["tets_strain"], sigma_min=1.0)
    q0 = bar.q0[union]
    dt = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
          for k, v in data.items()}
    dj = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in data_j.items()}
    s = svd3x3(projections._tet_F(torch.tensor(q0), dt))[1]
    assert bool((s == 1.0).all())
    W = rng.standard_normal((3 * len(dt["elements"]), 3))
    gj = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_projections.tets_strain_p(x, dj) * W))(jnp.asarray(q0)))
    q = torch.tensor(q0, requires_grad=True)
    (projections.tets_strain_p(q, dt) * torch.tensor(W)).sum().backward()
    assert rel(q.grad, gj) < 1e-12
