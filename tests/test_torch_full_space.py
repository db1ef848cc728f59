"""The reduced solver's configurations that are not fully reduced
(``AnimSnapBasesSolver`` with full groups beside reduced ones, or with the
positions full) against the JAX package's solver on the same bases
``.npz``, float64 on the CPU, on a 9x9 cloth.

The paths: positions reduced with ``edge_spring`` full ("mixed"), positions
reduced with no group reduced, positions full with the dense Cholesky
factor (3N = 243 <= DENSE_LIMIT) and with the host LU (DENSE_LIMIT set to
0 on both solvers), each through ``step()`` and ``run_steps``; the host
path's recording of the full groups' projections (``set_store_p``).  Each
is held within 1e-9 of the scene's extent after 8 steps at 6 iterations
(both packages solve the same float64 systems; the measured gaps are
rounding, below 1e-12).  The batched runners serve "mixed" and "dense"
(``tests/test_torch_full_space_batched.py``) and refuse the host LU.
"""

import os

import numpy as np
import pytest

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_torch_block_bases import one_thread  # noqa: F401
from test_torch_fused_reduced import DAMPING, gravity, small_model

STEPS = 8
ITERS = 6
ROWS = 9
TOL = 1e-9


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """Real bases of the 9x9 cloth: a JAX full-order recording, then
    pod_vectorized + row DEIM (6 modes) per group and an 8-mode position
    POD."""
    from reduction_helpers import record_and_build_bases
    from test_sim_solver import sim_args

    tmp = tmp_path_factory.mktemp("a4")
    basis_dir, pos_path, _ = record_and_build_bases(
        tmp, lambda: small_model(JaxModel, jax_cloth, ROWS, ROWS), sim_args(),
        frames=16, iters=ITERS, num_modes=6, pos_modes=8)
    return basis_dir, pos_path


def config(bases, position_reduced, reduced=("tris_strain",)):
    from test_sim_solver import sim_args

    basis_dir, pos_path = bases
    return sim_args(
        constraint_projection_basis_type="deim_pod_vectorized",
        tri_strain_reduced="tris_strain" in reduced,
        tri_strain_num_components=6,
        edge_spring_reduced="edge_spring" in reduced,
        edge_spring_num_components=6,
        geom_interpolation_basis_dir=basis_dir,
        geom_interpolation_basis_file="basis.npz",
        position_reduced=position_reduced, position_num_components=8,
        position_basis_file=pos_path, damping=DAMPING)


def pair(args, dense_limit=None):
    """(JAX solver, its model, port solver, its model), prepared."""
    out = []
    for cls, model, kw in (
            (JaxSolver, small_model(JaxModel, jax_cloth, ROWS, ROWS),
             {"pallas_mode": "off"}),
            (AnimSnapBasesSolver, small_model(DeformableModel, rows=ROWS,
                                              cols=ROWS), {"device": "cpu"})):
        s = cls(args, **kw)
        if dense_limit is not None:
            s.DENSE_LIMIT = dense_limit
        s.set_model(model)
        s.prepare(args)
        out += [s, model]
    return out


def assert_agree(m_jax, m_port):
    extent = np.abs(m_jax.positions).max()
    dP = np.abs(m_port.positions - m_jax.positions).max()
    dV = np.abs(m_port.velocities - m_jax.velocities).max()
    assert dP <= TOL * extent, dP
    assert dV <= TOL * np.abs(m_jax.velocities).max(), dV


CASES = {
    "mixed": (True, ("tris_strain",), None, "mixed"),
    "positions reduced, no group reduced": (True, (), None, "mixed"),
    "dense": (False, ("tris_strain", "edge_spring"), None, "dense"),
    "dense, edge_spring full": (False, ("tris_strain",), None, "dense"),
    "host": (False, ("tris_strain",), 0, "host"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_space_paths_match_jax(bases, case):
    position_reduced, reduced, limit, mode = CASES[case]
    args = config(bases, position_reduced, reduced)
    s_jax, m_jax, s_port, m_port = pair(args, limit)
    assert s_port._full is not None and s_port._full.mode == mode
    f = gravity(m_jax)
    for _ in range(STEPS // 2):
        s_jax.step(f, num_iterations=ITERS)
        s_port.step(f, num_iterations=ITERS)
    assert_agree(m_jax, m_port)
    traj_j = s_jax.run_steps(f, STEPS // 2, num_iterations=ITERS,
                             record=True)
    traj_p = s_port.run_steps(f, STEPS // 2, num_iterations=ITERS,
                              record=True)
    assert s_port.frame == s_jax.frame == STEPS
    assert np.abs(m_jax.velocities).max() > 0.5          # the cloth moved
    assert_agree(m_jax, m_port)
    np.testing.assert_allclose(traj_p, traj_j, rtol=0,
                               atol=TOL * np.abs(traj_j).max())
    if m_jax.floor_collision and mode != "host":
        np.testing.assert_allclose(m_port.positions_corrections,
                                   m_jax.positions_corrections, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("limit", [None, 0])
def test_full_groups_recording_matches_jax(bases, tmp_path, limit):
    """set_store_p(True) with edge_spring full and the positions full: a
    recorded run steps on the host path (dense factor or LU), records
    edge_spring's projections per frame and flushes them at
    max_p_snapshots_num, as the JAX solver does; with the positions
    reduced, recording raises in both."""
    args = config(bases, False)
    s_jax, m_jax, s_port, m_port = pair(args, limit)
    paths = {}
    for s, label in ((s_jax, "jax"), (s_port, "port")):
        paths[label] = str(tmp_path / label)
        s.set_record_path(paths[label])
        s.set_store_p(True)
        s.max_p_snapshots_num = STEPS - 1
        s.run_steps(gravity(m_jax), STEPS, num_iterations=ITERS,
                    record=True)
    assert_agree(m_jax, m_port)
    a = np.load(os.path.join(paths["jax"], "edge_spring_p.npz"))
    b = np.load(os.path.join(paths["port"], "edge_spring_p.npz"))
    assert a.files == b.files and len(a.files) == STEPS
    scale = max(np.abs(a[k]).max() for k in a.files)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=TOL * scale)
    assert not os.path.exists(os.path.join(paths["port"],
                                           "tris_strain_p.npz"))

    args = config(bases, True)
    s_jax, m_jax, s_port, _ = pair(args)
    for s in (s_jax, s_port):
        s.set_store_p(True)
        with pytest.raises(RuntimeError, match="position reduction"):
            s.step(gravity(m_jax), num_iterations=ITERS)


def test_batched_runners_refuse_naming_a4b(bases):
    """The batched runners once refused these configurations naming A4b.
    They serve them now on the batched full-space step (held against the
    JAX runners in ``tests/test_torch_full_space_batched.py``): here "dense"
    serves both runners, each sim its solo step, and the host LU alone
    still refuses, with ``RuntimeError`` as the JAX solver does."""
    args = config(bases, False)
    _, _, s_port, m_port = pair(args)
    B = 2
    state = [np.repeat(x[None], B, axis=0) for x in (
        m_port.positions, m_port.velocities, gravity(m_port))]
    p, _ = s_port.make_batched_run()(*state, 2)
    assert s_port._last_batched_path == "batched-full"
    assert np.isfinite(p).all() and np.abs(p[0] - p[1]).max() == 0
    p, v = s_port.make_batched_step()(*state)
    s_port.step(state[2][0])
    np.testing.assert_allclose(p[0], m_port.positions, rtol=0,
                               atol=1e-12 * np.abs(p).max())
    _, _, s_host, _ = pair(args, dense_limit=0)
    with pytest.raises(RuntimeError, match="host LU"):
        s_host.make_batched_run()(*state, 2)
    with pytest.raises(RuntimeError, match="host LU"):
        s_host.make_batched_step()(*state)


def test_prepare_raises_when_the_factorization_fails(bases):
    """Nothing falls back: a global matrix that is not positive definite
    makes the dense factor raise at prepare()."""
    import torch

    args = config(bases, False)
    s = AnimSnapBasesSolver(args, device="cpu")
    model = small_model(DeformableModel, rows=ROWS, cols=ROWS)
    model.mass = -model.mass
    s.set_model(model)
    with pytest.raises(torch.linalg.LinAlgError):
        s.prepare(args)
