"""Self-collision in the port's solvers against the JAX package's, float64
on the CPU, each held to 1e-9 of the scene's extent.

* The full-order ``Solver`` on the 6x12 cloth of
  ``tests/test_self_collision.py`` folded onto itself (layers 0.6 min_dist
  apart, jittered so that no two candidate centroids tie), squeezed
  together: ``"device"`` and True through ``step()`` and ``run_steps``.
* The reduced solver on the 5x5 cloth of that file's reduced tests
  (jittered, real POD/DEIM bases of a JAX recording at each scale), the
  JAX solver in ``pallas_mode="interpret"`` so that its serving tier runs:
  the captured step (scale 0.004), the clear-window tier on kernel 5
  (scale 1: the certificate set), the proximity hand-back to kernel 1 with
  the pass (scale 0.0008: the certificate None),
  ``self_collision_resident = False``, ``self_collision_budget_windows =
  0``, an animated schedule (the host-window path), the pass set after
  prepare (out of band) and the host resolvers.
"""

import numpy as np
import pytest

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxReduced
from animsnapbases_tpu.sim.solver import Solver as JaxSolver
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from animsnapbases_tpu_torch.sim.solver import Solver
from test_sim_solver import sim_args
from test_torch_block_bases import one_thread  # noqa: F401

TOL = 1e-9
ITERS = 4
FOM_STEPS = 6


def assert_agree(m_jax, m_port, what=""):
    extent = np.abs(m_jax.positions).max()
    dP = np.abs(m_port.positions - m_jax.positions).max()
    dV = np.abs(m_port.velocities - m_jax.velocities).max()
    assert dP <= TOL * extent, (what, dP, extent)
    assert dV <= TOL * max(np.abs(m_jax.velocities).max(), extent), (what, dV)


# ---------------------------------------------------------------------------
# the full-order solver
# ---------------------------------------------------------------------------

def folded(cls, cloth):
    V, F = cloth(6, 12)
    V = V * 0.004
    y = V[:, 1]
    top = y > 5.5 * 0.004
    V2 = V.copy()
    V2[top, 1] = 11 * 0.004 - y[top]
    V2[top, 2] += 0.0006
    V2 = V2 + np.random.default_rng(5).normal(scale=2e-5, size=V2.shape)
    model = cls(V2, F, masses=np.full(len(V2), 10.0), floor_collision=False)
    model.add_edge_spring_constraint(wi=1e4)
    return model


def squeeze(model):
    f = np.zeros_like(model.positions)
    f[:, 2] = -9.81 * 10.0 * 0.01
    return f


def fom_pair(mode):
    out = []
    for solver, model in ((JaxSolver(), folded(JaxModel, jax_cloth)),
                          (Solver(device="cpu"),
                           folded(DeformableModel, cloth_model))):
        solver.enable_self_collision = mode
        solver.set_model(model)
        solver.prepare(sim_args())
        out += [solver, model]
    return out


@pytest.mark.parametrize("mode", ["device", True])
def test_fom_solver_matches_jax(mode):
    s_jax, m_jax, s_port, m_port = fom_pair(mode)
    _, m_off, _, _ = fom_pair(False)
    s_off = JaxSolver()
    s_off.set_model(m_off)
    s_off.prepare(sim_args())
    f = squeeze(m_jax)
    for _ in range(FOM_STEPS):
        s_jax.step(f, num_iterations=ITERS)
        s_port.step(f, num_iterations=ITERS)
        s_off.step(f, num_iterations=ITERS)
    assert_agree(m_jax, m_port, "step")
    # the passes pushed: the run differs from the run without them
    assert np.abs(m_off.positions - m_jax.positions).max() > 1e-5
    s_jax.run_steps(f, FOM_STEPS, num_iterations=ITERS)
    s_port.run_steps(f, FOM_STEPS, num_iterations=ITERS)
    assert_agree(m_jax, m_port, "run_steps")
    assert s_port.frame == 2 * FOM_STEPS


# ---------------------------------------------------------------------------
# the reduced solver
# ---------------------------------------------------------------------------

# a 16-frame z-motion of the centre vertex, small enough that the reduced
# scene stays in its linear range (at 5e-4 its velocities reach ~3 in 6
# steps and the two packages' 2x2 SVDs part by ~1e-9)
POKE = np.zeros((16, 3))
POKE[:, 2] = 5e-5 * np.sin(np.linspace(0.0, np.pi, 16))


def cloth5(cls, cloth, scale, animated=False):
    V, F = cloth(5, 5)
    V = V.copy() * scale
    V[:, 2] += 0.1 * V[:, 0]
    V = V + np.random.default_rng(3).normal(scale=0.01 * scale,
                                            size=V.shape)
    model = cls(V, F, masses=np.full(len(V), 10.0), floor_collision=False)
    model.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    model.add_edge_spring_constraint(wi=1e4)
    if animated:
        model.add_positional_constraint(12, wi=10.0,
                                        motion_type="user_defined",
                                        frame_shift=POKE * scale)
    return model


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """Real bases of the 5x5 cloth at a scale: a JAX full-order recording,
    pod_vectorized + row DEIM (8 modes a group) and a 10-mode position
    POD, made once per (scale, animated)."""
    from reduction_helpers import record_and_build_bases

    made = {}

    def get(scale, animated=False):
        key = (scale, animated)
        if key not in made:
            tmp = tmp_path_factory.mktemp("sc")
            basis_dir, pos_path, _ = record_and_build_bases(
                tmp, lambda: cloth5(JaxModel, jax_cloth, scale, animated),
                sim_args())
            made[key] = sim_args(
                constraint_projection_basis_type="deim_pod_vectorized",
                tri_strain_reduced=True, tri_strain_num_components=8,
                edge_spring_reduced=True, edge_spring_num_components=8,
                geom_interpolation_basis_dir=basis_dir,
                geom_interpolation_basis_file="basis.npz",
                position_reduced=True, position_num_components=10,
                position_basis_file=pos_path)
        return made[key]

    return get


def reduced_pair(args, scale, mode="device", animated=False, **switches):
    """(JAX solver in interpret mode, its model, port solver, its model)
    with ``enable_self_collision = mode`` before prepare."""
    out = []
    for solver, model in (
            (JaxReduced(args, pallas_mode="interpret"),
             cloth5(JaxModel, jax_cloth, scale, animated)),
            (AnimSnapBasesSolver(args, device="cpu"),
             cloth5(DeformableModel, cloth_model, scale, animated))):
        solver.enable_self_collision = mode
        for k, v in switches.items():
            setattr(solver, k, v)
        solver.set_model(model)
        solver.prepare(args)
        out += [solver, model]
    return out


def gravity(model, g=0.01):
    f = np.zeros_like(model.positions)
    f[:, 1] = -9.81 * 10.0 * g
    return f


def test_captured_step_matches_jax(bases):
    """Scale 0.004 (clearance ~4x min_dist): "device" captured at prepare
    into kernel 1's step, then run_steps on the tier, against the JAX
    solver's step and run_steps."""
    args = bases(0.004)
    s_jax, m_jax, s_port, m_port = reduced_pair(args, 0.004)
    assert s_port._collision_mode == "device"
    assert s_port._resident_fast is not None
    f = gravity(m_jax)
    for _ in range(5):
        s_jax.step(f, num_iterations=ITERS)
        s_port.step(f, num_iterations=ITERS)
    assert_agree(m_jax, m_port, "step")
    s_jax.run_steps(f, 5, num_iterations=ITERS)
    s_port.run_steps(f, 5, num_iterations=ITERS)
    assert_agree(m_jax, m_port, "run_steps")
    assert s_port._last_fast_steps == s_jax._last_fast_steps
    assert np.isfinite(m_port.positions).all()


@pytest.mark.parametrize("budget_windows", [8, 0])
def test_clear_windows_serve_on_tier1(bases, budget_windows):
    """Scale 1 (clearance ~1000x min_dist): the whole call on tier 1, the
    certificate set, against the JAX fused loop; with
    ``self_collision_budget_windows = 0`` the exact probe runs at every
    window and the trajectory is the default's."""
    args = bases(1.0)
    s_jax, m_jax, s_port, m_port = reduced_pair(
        args, 1.0, self_collision_budget_windows=budget_windows,
        self_collision_window_cap=5)
    f = gravity(m_jax, 0.001)
    s_jax.run_steps(f, 12, num_iterations=ITERS)
    s_port.run_steps(f, 12, num_iterations=ITERS)
    assert s_jax._last_fast_steps == s_port._last_fast_steps == 12
    windows = s_port._last_sc_windows
    assert [w["path"] for w in windows] == ["tier 1"] * 3
    assert [w["steps"] for w in windows] == [5, 5, 2]
    probes = [w["probe"] for w in windows]
    assert all(probes) if budget_windows == 0 else not all(probes)
    assert_agree(m_jax, m_port, "clear windows")
    if budget_windows == 0:
        _, _, s_def, m_def = reduced_pair(args, 1.0,
                                          self_collision_window_cap=5)
        s_def.run_steps(f, 12, num_iterations=ITERS)
        np.testing.assert_array_equal(m_def.positions, m_port.positions)


def test_proximity_hands_back_to_kernel1(bases):
    """Scale 0.0008 (vertex spacing under min_dist): no window is
    certified, the steps run on kernel 1 with the pass (pushing), the
    certificate stays None; against the JAX solver's run_steps and its
    exact per-step path."""
    args = bases(0.0008)
    s_jax, m_jax, s_port, m_port = reduced_pair(args, 0.0008)
    start = m_port.positions.copy()
    f = gravity(m_jax)
    s_jax.run_steps(f, 8, num_iterations=ITERS)
    s_port.run_steps(f, 8, num_iterations=ITERS)
    assert s_jax._last_fast_steps is None and s_port._last_fast_steps is None
    assert [w["path"] for w in s_port._last_sc_windows] == ["per-step"]
    assert_agree(m_jax, m_port, "proximity")
    # the pass pushed: the run without it ends elsewhere
    _, _, s_off, m_off = reduced_pair(args, 0.0008, mode=False)
    m_off.positions = start.copy()
    s_off.run_steps(f, 8, num_iterations=ITERS)
    assert np.abs(m_off.positions - m_port.positions).max() > 1e-6


def test_resident_off_steps_on_kernel1(bases):
    """``self_collision_resident = False`` builds no tiers; run_steps
    serves kernel 1 with the pass, step by step, as the JAX solver's
    per-step path."""
    args = bases(0.004)
    s_jax, m_jax, s_port, m_port = reduced_pair(
        args, 0.004, self_collision_resident=False)
    assert getattr(s_jax, "_resident", None) is None
    assert s_port._resident_fast is None and s_port._resident_run is None
    f = gravity(m_jax)
    s_jax.run_steps(f, 5, num_iterations=ITERS)
    s_port.run_steps(f, 5, num_iterations=ITERS)
    assert s_port._last_sc_windows is None
    assert_agree(m_jax, m_port, "resident off")


def test_animated_schedule_takes_host_windows(bases):
    """An animated positional target: the clear windows are nested
    run_steps on the tiers with the flag off (the host-window path), as in
    the JAX solver, across the schedule's end."""
    args = bases(1.0, animated=True)
    s_jax, m_jax, s_port, m_port = reduced_pair(
        args, 1.0, animated=True, self_collision_window_cap=6)
    f = gravity(m_jax, 0.001)
    s_jax.run_steps(f, 20, num_iterations=ITERS)
    s_port.run_steps(f, 20, num_iterations=ITERS)
    windows = s_port._last_sc_windows
    assert {w["path"] for w in windows} == {"tiers"}
    assert sum(w["steps"] for w in windows) == 20
    assert s_port._last_fast_steps == s_jax._last_fast_steps == 20
    assert s_port.frame == s_jax.frame == 20
    assert_agree(m_jax, m_port, "animated")


@pytest.mark.parametrize("mode", ["device", True])
def test_pass_set_after_prepare_and_host_resolvers(bases, mode):
    """The pass asked for after prepare (out of band in step(), and
    run_steps step by step) and the host resolvers, on the proximity
    scene, against the JAX solver."""
    args = bases(0.0008)
    s_jax, m_jax, s_port, m_port = reduced_pair(args, 0.0008, mode=False)
    for s in (s_jax, s_port):
        s.enable_self_collision = mode
    assert s_port._collision_mode is False
    f = gravity(m_jax)
    s_jax.step(f, num_iterations=ITERS)
    s_port.step(f, num_iterations=ITERS)
    s_jax.run_steps(f, 3, num_iterations=ITERS)
    s_port.run_steps(f, 3, num_iterations=ITERS)
    assert s_port._last_fast_steps is None
    assert_agree(m_jax, m_port, f"{mode} after prepare")
