"""The port's serving path as a whole (``AnimSnapBasesSolver``: prepare ->
step / run_steps) against the JAX package's solver on the same bases
``.npz``, float64 on the CPU.

Three cases of one parametrised test: the JAX package's synthetic bases
(``utils/synthetic.py``) as they are, the same constraint bases with a
position basis that spares the pinned vertices, and real POD/DEIM bases
recorded by the JAX package's full-order solver
(``tests/reduction_helpers.record_and_build_bases``).  The JAX reference is
its ``pallas_mode="off"`` step loop; the tolerances are the ones the JAX
package holds its own resident kernels to against that loop
(``tests/test_damping.py``).  Measured max differences after 8 steps at 6
iterations, the same for step() and run_steps: synthetic |dP| 3.6e-15,
|dV| 5.6e-14 (|V| ~1); free basis |dP| 2.5e-14, |dV| 3.3e-13 (|V| ~15);
POD |dP| 4.4e-10, |dV| 9.0e-9 (|V| ~1; the JAX loop projects with the
Jacobi ``svd2x2``, the port with the closed-form clamp).
"""

import numpy as np
import pytest

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_torch_fused_reduced import (
    DAMPING,
    gravity,
    jax_solver,
    port_solver,
    small_model,
)

STEPS = 8
ITERS = 6


def _pod_args(tmp_path):
    """Real bases: a JAX full-order recording of the small scene, then
    pod_vectorized + row DEIM (6 modes and rows) and an 8-mode position
    POD."""
    from reduction_helpers import record_and_build_bases
    from test_sim_solver import sim_args

    basis_dir, pos_path, _ = record_and_build_bases(
        tmp_path, lambda: small_model(JaxModel, jax_cloth), sim_args(),
        frames=16, iters=ITERS, num_modes=6, pos_modes=8)
    return sim_args(
        constraint_projection_basis_type="deim_pod_vectorized",
        tri_strain_reduced=True, tri_strain_num_components=6,
        edge_spring_reduced=True, edge_spring_num_components=6,
        geom_interpolation_basis_dir=basis_dir,
        geom_interpolation_basis_file="basis.npz",
        position_reduced=True, position_num_components=8,
        position_basis_file=pos_path, damping=DAMPING)


def _jax_pair(tmp_path, bases):
    """(JAX solver in "off" mode, its model, JAX solver in "interpret" mode
    for the resident state) on one set of bases."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    if bases == "pod":
        args = _pod_args(tmp_path)
    else:
        s, _ = jax_solver(tmp_path, "off", free_basis=(bases == "free"))
        args = s.args
    out = []
    for mode in ("off", "interpret"):
        model = small_model(JaxModel, jax_cloth)
        s = JaxSolver(args, pallas_mode=mode)
        s.set_model(model)
        s.prepare(args)
        out += [s, model]
    return args, out[0], out[1], out[2]


@pytest.mark.parametrize("bases", ["synthetic", "free", "pod"])
def test_serving_path_matches_jax(tmp_path, bases):
    args, s_jax, m_jax, s_res = _jax_pair(tmp_path, bases)
    s_port, m_port = port_solver(args)

    # prepare: the same host matrices, DEIM rows and permutation
    np.testing.assert_allclose(s_port._inv_np, s_jax._inv_np, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(s_port._ut_ac_np, s_jax._ut_ac_np,
                               rtol=1e-12, atol=1e-12 * np.abs(
                                   s_jax._ut_ac_np).max())
    for name, rg in s_jax._reduced_groups.items():
        mine = s_port._reduced_groups[name]
        np.testing.assert_allclose(mine.W, rg.W, rtol=1e-12,
                                   atol=1e-12 * np.abs(rg.W).max())
        np.testing.assert_array_equal(mine.row_select, rg.row_select)
    np.testing.assert_array_equal(s_port._resident.perm,
                                  s_res._resident_state["perm"])

    # step() loop and run_steps against the JAX per-step loop
    f = gravity(m_jax)
    for _ in range(STEPS):
        s_jax.step(f, num_iterations=ITERS)
        s_port.step(f, num_iterations=ITERS)
    m_run = small_model(DeformableModel)
    s_run = AnimSnapBasesSolver(args, device="cpu")
    s_run.set_model(m_run)
    s_run.prepare(args)
    s_run.run_steps(f, STEPS, num_iterations=ITERS)

    assert np.abs(m_jax.velocities).max() > 0.5       # the cloth moved
    assert s_port.frame == s_run.frame == STEPS
    for m in (m_port, m_run):
        np.testing.assert_allclose(m.positions, m_jax.positions, atol=1e-6)
        np.testing.assert_allclose(m.velocities, m_jax.velocities,
                                   atol=1e-4)
    np.testing.assert_allclose(m_port.positions_corrections,
                               m_jax.positions_corrections, atol=1e-9)


def test_unported_configurations_raise(tmp_path):
    """What the port once refused is served: the host self-collision
    resolvers in run_steps (step by step through step(), as the JAX solver
    does; ``tests/test_torch_self_collision.py`` holds the modes against
    it), and the batched runners on a configuration with a full
    (unreduced) group (the batched full-space step, each sim its solo
    step; ``tests/test_torch_full_space_batched.py`` holds it against the
    JAX runners).  Kernel 5's build options are served:
    each switch reaches the build that tier 1 runs (ops/affine_chunked.py
    ChunkOptions), and prepare() no longer refuses them."""
    from animsnapbases_tpu_torch.ops.affine_chunked import ChunkOptions

    s_jax, _ = jax_solver(tmp_path, "off")
    s, m = port_solver(s_jax.args)
    f = gravity(m)
    s_ref, m_ref = port_solver(s_jax.args)
    for solver in (s, s_ref):
        solver.enable_self_collision = True
    s.run_steps(f, 2)
    for _ in range(2):
        s_ref.step(f)
    assert s.frame == 2 and s._last_fast_steps is None
    np.testing.assert_array_equal(m.positions, m_ref.positions)
    np.testing.assert_array_equal(m.velocities, m_ref.velocities)
    s.enable_self_collision = False
    for name, value, build in (
            ("resident_floor_bound_skip", False,
             ChunkOptions(floor_bound_skip=False)),
            ("resident_floor_exact", True, ChunkOptions()),
            ("resident_floor_exact", False, ChunkOptions(floor_exact=False)),
            ("resident_chunked_opts", {"fold_vc": False},
             ChunkOptions(fold_vc=False))):
        s2, _ = port_solver(s_jax.args)
        setattr(s2, name, value)
        s2.set_dirty()
        s2.prepare(s_jax.args)
        assert s2._resident_fast.keywords["options"] == build, name
        s2.run_steps(f, 2)
        assert s2.frame == 2
    s2, _ = port_solver(s_jax.args)
    s2.resident_floor_bound_skip = True          # the default
    s2.resident_chunked_opts = {}
    s2.prepare(s_jax.args)
    assert s2._resident_fast.keywords["options"] == ChunkOptions()

    args = s_jax.args
    args.edge_spring_reduced = False           # a full (unreduced) group
    s2 = AnimSnapBasesSolver(args, device="cpu")
    s2.set_model(small_model(DeformableModel))
    s2.prepare(args)
    s2.step(f)
    assert s2.frame == 1 and s2._full.mode == "mixed"
    B = [np.repeat(x[None], 2, axis=0) for x in (
        s2.model.positions, s2.model.velocities, f)]
    p, v = s2.make_batched_step()(*B)
    s2.step(f)
    assert s2._full.mode == "mixed"
    extent = np.abs(s2.model.positions).max()
    for b in range(2):
        np.testing.assert_allclose(p[b], s2.model.positions, rtol=0,
                                   atol=1e-12 * extent)
        np.testing.assert_allclose(v[b], s2.model.velocities, rtol=0,
                                   atol=1e-12 * np.abs(v).max())


def test_static_positional_targets_match_jax(tmp_path):
    """A static positional group enters as rb_extra = U^T S^T targets in
    both step() and run_steps, as in the JAX solver."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    s_tmp, _ = jax_solver(tmp_path, "off")
    args = s_tmp.args
    models = [small_model(JaxModel, jax_cloth), small_model(DeformableModel),
              small_model(DeformableModel)]
    for m in models:
        m.add_positional_constraint(99, wi=1e4)
    s_jax = JaxSolver(args, pallas_mode="off")
    s_jax.set_model(models[0])
    s_jax.prepare(args)
    solvers = []
    for m in models[1:]:
        s = AnimSnapBasesSolver(args, device="cpu")
        s.set_model(m)
        s.prepare(args)
        solvers.append(s)
    f = gravity(models[0])
    for _ in range(4):
        s_jax.step(f, num_iterations=ITERS)
        solvers[0].step(f, num_iterations=ITERS)
    solvers[1].run_steps(f, 4, num_iterations=ITERS)
    for m in models[1:]:
        np.testing.assert_allclose(m.positions, models[0].positions,
                                   atol=1e-6)
