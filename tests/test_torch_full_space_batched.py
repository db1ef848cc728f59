"""Batched serving of the configurations that are not fully reduced: the
port's ``make_batched_run`` and ``make_batched_step`` on the batched
full-space step against the JAX package's vmapped runners, float64 on the
CPU, on the 9x9 cloth and bases of ``tests/test_torch_full_space.py``
with a static positional target added (so that a timeline has rows).

"mixed" (positions reduced, ``edge_spring`` full) and "dense" (positions
full, the dense Cholesky factor solved with a right-hand side per sim),
each at B = 3 with per-sim gravity, on the model's own timeline, on a
timeline the sims share and on one per sim, held at ``TOL`` (1e-9) of the
extent; each sim of a batched call against its solo ``run_steps`` /
``step()`` on the port to 1e-12 of the extent; the host LU raises
``RuntimeError`` in both packages.
"""

import numpy as np
import pytest

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_torch_block_bases import one_thread  # noqa: F401
from test_torch_fused_reduced import gravity, small_model
from test_torch_full_space import (  # noqa: F401
    ITERS,
    ROWS,
    TOL,
    bases,
    config,
)

STEPS = 4
SCALES = (1.0, 1.2, 0.8)
TARGET = 40                 # a vertex of the 9x9 cloth's middle
SOLO_TOL = 1e-12
DT = 0.016

CASES = {"mixed": (True, ("tris_strain",)),
         "dense": (False, ("tris_strain", "edge_spring"))}


def model_with_target(cls, cloth=None):
    model = (small_model(cls, cloth, ROWS, ROWS) if cloth is not None
             else small_model(cls, rows=ROWS, cols=ROWS))
    model.add_positional_constraint(TARGET, wi=1e4)
    return model


def solvers(args, dense_limit=None, mode=False):
    """(JAX solver "off", its model, port solver, its model), prepared with
    ``enable_self_collision = mode``."""
    out = []
    for cls, model, kw in (
            (JaxSolver, model_with_target(JaxModel, jax_cloth),
             {"pallas_mode": "off"}),
            (AnimSnapBasesSolver, model_with_target(DeformableModel),
             {"device": "cpu"})):
        s = cls(args, **kw)
        if dense_limit is not None:
            s.DENSE_LIMIT = dense_limit
        s.enable_self_collision = mode
        s.set_model(model)
        s.prepare(args)
        out += [s, model]
    return out


def ensemble(model):
    B = len(SCALES)
    pos = np.tile(model.positions, (B, 1, 1))
    return pos, np.zeros_like(pos), np.stack([gravity(model) * s
                                              for s in SCALES])


def timeline(model, kind):
    """None, a shared (T, 1, 3) timeline or a per-sim (B, T, 1, 3) one:
    the target lifted by up to 0.05 over T = 3 rows."""
    if kind is None:
        return None
    p0 = model.positional_targets(0)
    rows = np.stack([p0 + [0.0, 0.02 * t, 0.0] for t in range(3)])
    if kind == "shared":
        return rows
    return np.stack([rows + [0.0, 0.01 * b, 0.0]
                     for b in range(len(SCALES))])


def close(got, want, tol=TOL):
    """Positions within ``tol`` of the extent, velocities within ``tol`` of
    the larger of their own scale and the extent over dt (a velocity is a
    position difference over dt)."""
    (gp, gv), (wp, wv) = got, [np.asarray(x) for x in want]
    extent = np.abs(wp).max()
    np.testing.assert_allclose(gp, wp, rtol=0, atol=tol * extent)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol * max(
        np.abs(wv).max(), extent / DT))


@pytest.mark.parametrize("kind", [None, "shared", "per-sim"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_run_matches_jax(bases, case, kind):
    args = config(bases, *CASES[case])
    s_jax, m_jax, s_port, m_port = solvers(args)
    assert s_port._full.mode == case
    pos, vel, fs = ensemble(m_port)
    tl = timeline(m_port, kind)
    run_j, run_p = s_jax.make_batched_run(), s_port.make_batched_run()
    want, got = [], []
    for _ in range(2):                 # two calls: the serving frame moves
        want = [np.asarray(x) for x in run_j(
            pos, vel, fs, STEPS, num_iterations=ITERS, targets_seq=tl)]
        got = run_p(pos, vel, fs, STEPS, num_iterations=ITERS,
                    targets_seq=tl)
        close(got, want)
        pos, vel = got
    assert s_jax._last_batched_path == "vmapped-xla"
    assert s_port._last_batched_path == "batched-full"
    assert np.abs(got[1]).max() > 0.1                   # the sims moved
    if kind is None:
        # each sim against its solo run_steps from its own state
        start = ensemble(m_port)
        for b in range(len(SCALES)):
            m_port.positions = start[0][b].copy()
            m_port.velocities = start[1][b].copy()
            s_port.frame = 0
            s_port.run_steps(start[2][b], 2 * STEPS, num_iterations=ITERS)
            close((m_port.positions, m_port.velocities),
                  (got[0][b], got[1][b]), SOLO_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_step_matches_jax(bases, case):
    args = config(bases, *CASES[case])
    s_jax, m_jax, s_port, m_port = solvers(args)
    pos, vel, fs = ensemble(m_port)
    step_j, step_p = s_jax.make_batched_step(), s_port.make_batched_step()
    targets = m_port.positional_targets(0) + [0.0, 0.03, 0.0]
    for t in (None, targets):
        want = [np.asarray(x) for x in step_j(pos, vel, fs, ITERS,
                                              targets=t)]
        got = step_p(pos, vel, fs, ITERS, targets=t)
        close(got, want)
    # each sim against its solo step() (the model's targets)
    got = step_p(pos, vel, fs, ITERS)
    for b in range(len(SCALES)):
        m_port.positions, m_port.velocities = pos[b].copy(), vel[b].copy()
        s_port.frame = 2
        s_port.step(fs[b], num_iterations=ITERS)
        close((m_port.positions, m_port.velocities),
              (got[0][b], got[1][b]), SOLO_TOL)


def test_batched_step_applies_the_captured_pass(bases):
    """"device" captured at prepare: the batched dense step applies the
    pass per sim, as the JAX vmapped step core does; the cloth scaled to
    0.008, its vertex spacing under min_dist, so that the pass pushes."""
    args = config(bases, *CASES["dense"])
    s_jax, m_jax, s_port, m_port = solvers(args, mode="device")
    assert s_port._full.collide is not None
    pos, vel, fs = ensemble(m_port)
    pos = pos * 0.008
    want = [np.asarray(x) for x in s_jax.make_batched_step()(pos, vel, fs,
                                                             ITERS)]
    got = s_port.make_batched_step()(pos, vel, fs, ITERS)
    close(got, want)
    off = solvers(args)[2].make_batched_step()(pos, vel, fs, ITERS)
    assert np.abs(off[0] - got[0]).max() > 1e-5          # the pass pushed
    with pytest.raises(RuntimeError, match="self-collision"):
        s_port.make_batched_run()


def test_host_lu_refuses_batched_serving(bases):
    args = config(bases, False, ("tris_strain",))
    s_jax, m_jax, s_port, m_port = solvers(args, dense_limit=0)
    assert s_port._full.mode == "host"
    state = ensemble(m_port)
    for make in (s_jax.make_batched_run, s_jax.make_batched_step):
        with pytest.raises(RuntimeError, match="jitted path"):
            make()
    with pytest.raises(RuntimeError, match="host LU"):
        s_port.make_batched_run()(*state, 2)
    with pytest.raises(RuntimeError, match="host LU"):
        s_port.make_batched_step()(*state)
