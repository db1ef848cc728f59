"""The port's tiered ``run_steps`` (tier 1, then the contact tier) against the
JAX package's ``pallas_mode="off"`` step loop on the same bases, float64 on
the CPU, mirroring ``tests/test_resident_kernel.py``'s tier tests: P to
1e-6 and V to 1e-4, the tolerances the JAX package holds its own tiers to.

The small scene is lifted 3 units so that gravity leaves a contact-free
window; 10x gravity then slams it into the floor.  ``resident_rebase_every
= 4`` makes both windows cross chunk boundaries and in-kernel rebases.
"""

import numpy as np
import pytest

from animsnapbases_tpu.geometry.procedural import cloth_model as jax_cloth
from animsnapbases_tpu.sim.model import DeformableModel as JaxModel
from animsnapbases_tpu_torch.ops.affine import (
    resident_affine,
    resident_affine_contact,
    resident_affine_exit,
)
from animsnapbases_tpu_torch.ops.affine_chunked import affine_chunked
from animsnapbases_tpu_torch.ops.resident import resident_multistep
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_torch_fused_reduced import gravity, jax_solver, small_model

ITERS = 6
LIFT = 3.0
FREE, SLAM = (1.0, 10), (10.0, 20)    # (force scale, steps) of each window


def _lifted(model, floor=True):
    model.positions[:, 1] += LIFT
    model.floor_collision = floor
    return model


def jax_reference(args, windows, floor=True):
    """The JAX "off" step loop over ``windows`` -> (positions, velocities)
    after each window."""
    from animsnapbases_tpu.sim.reduced import AnimSnapBasesSolver as JaxSolver

    model = _lifted(small_model(JaxModel, jax_cloth), floor)
    s = JaxSolver(args, pallas_mode="off")
    s.set_model(model)
    s.prepare(args)
    f = gravity(model)
    out = []
    for scale, steps in windows:
        for _ in range(steps):
            s.step(f * scale, num_iterations=ITERS)
        out.append((model.positions.copy(), model.velocities.copy()))
    return out


def port_tiers(args, floor=True, **switches):
    model = _lifted(small_model(DeformableModel), floor)
    s = AnimSnapBasesSolver(args, device="cpu")
    s.resident_rebase_every = 4
    for k, v in switches.items():
        setattr(s, k, v)
    s.set_model(model)
    s.prepare(args)
    return s, model


def spy_tier1(s):
    """Record the steps_done of every tier-1 call."""
    calls = []
    real = s._resident_fast

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[2])
        return out

    s._resident_fast = spy
    return calls


def _close(model, ref):
    np.testing.assert_allclose(model.positions, ref[0], atol=1e-6)
    np.testing.assert_allclose(model.velocities, ref[1], atol=1e-4)


# the tier switches of each configuration, and its (tier 1, contact tier)
CONFIGS = {
    "chunked": ({"resident_contact_mode": False},
                (affine_chunked, resident_affine)),
    "exit": ({"resident_chunked_tier1": False,
              "resident_contact_mode": False},
             (resident_affine_exit, resident_affine)),
    "standard": ({"CHUNKED_TIER1_MIN_VERTS": 4},
                 (affine_chunked, resident_multistep)),
    "contact_mode": ({"resident_contact_mode": True},
                     (affine_chunked, resident_affine_contact)),
    "contact_mode_no_tier1": ({"resident_contact_mode": True,
                               "resident_chunked_tier1": False},
                              (None, resident_affine_contact)),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_tiers_match_jax_step_loop(tmp_path, config):
    """The lean build (kernel 5, then kernel 3), with
    ``resident_chunked_tier1=False`` (kernel 4, then kernel 3),
    ``CHUNKED_TIER1_MIN_VERTS`` overridden (kernel 5, then kernel 2),
    ``resident_contact_mode=True`` (kernel 5, then kernel 3's contact-mode
    build) and contact mode without tier 1 (``resident_chunked_tier1=False``
    as well: no tier 1, as in the JAX solver, and the contact-mode kernel 3
    serves both windows): with a
    tier 1, the contact-free window is served whole by it and certified,
    and in the slam window tier 1 exits early, the contact tier finishes
    and the certificate is withheld.  Measured max |dP| 1.9e-13 and |dV|
    1.4e-12 after both windows (|V| ~ 25), the same in the five
    configurations."""
    switches, (tier1, contact) = CONFIGS[config]
    args = jax_solver(tmp_path, "off")[0].args
    ref = jax_reference(args, [FREE, SLAM])
    s, m = port_tiers(args, **switches)
    assert s._resident_run.func is contact
    assert s._resident_kind == ("standard" if config == "standard"
                                else "affine")
    f = gravity(m)
    if tier1 is None:
        assert s._resident_fast is None and s._resident_fast_kind is None
        s.run_steps(f * FREE[0], FREE[1], num_iterations=ITERS)
        assert s._last_fast_steps is None and s.frame == FREE[1]
        _close(m, ref[0])
        s.run_steps(f * SLAM[0], SLAM[1], num_iterations=ITERS)
    else:
        assert s._resident_fast.func is tier1
        assert s._resident_fast_kind == ("exit" if config == "exit"
                                         else "chunked")
        calls = spy_tier1(s)
        s.run_steps(f * FREE[0], FREE[1], num_iterations=ITERS)
        assert calls == [FREE[1]] and s._last_fast_steps == FREE[1]
        assert s.frame == FREE[1]
        _close(m, ref[0])
        s.run_steps(f * SLAM[0], SLAM[1], num_iterations=ITERS)
        assert 0 < calls[1] < SLAM[1]        # tier 1 exited at the contact
    assert s._last_fast_steps is None
    assert s.frame == FREE[1] + SLAM[1]
    assert m.positions[:, 1].min() > -0.5      # held at the floor
    _close(m, ref[1])


def test_zero_progress_falls_through(tmp_path):
    """Tier 1 reporting zero steps done (a working-dtype step-0 clamp that
    the float64 host check missed) hands the window to the contact tier
    once, without recursing."""
    args = jax_solver(tmp_path, "off")[0].args
    ref = jax_reference(args, [(1.0, 6)])
    s, m = port_tiers(args)
    calls = []

    def fake_zero(P, V, Fx, rb, steps, iters):
        calls.append(1)
        return P, V, 0

    s._resident_fast = fake_zero
    s.run_steps(gravity(m), 6, num_iterations=ITERS)
    assert calls == [1]
    assert s.frame == 6 and s._last_fast_steps is None
    _close(m, ref[0])


def test_floor_off_tier1_never_exits(tmp_path):
    """With the floor off, kernel 5 runs with the sentinel floor: the slam
    window carries the cloth through the floor plane in one certified
    window."""
    args = jax_solver(tmp_path, "off")[0].args
    ref = jax_reference(args, [SLAM], floor=False)
    s, m = port_tiers(args, floor=False)
    s.run_steps(gravity(m) * SLAM[0], SLAM[1], num_iterations=ITERS)
    assert s._last_fast_steps == SLAM[1]
    assert m.positions[:, 1].min() < -0.5
    _close(m, ref[0])


def test_contact_mode_default(tmp_path):
    """``resident_contact_mode=None`` resolves to the build that the H100's
    measurements chose for kernel 3 as the contact tier (PERF.md):
    contact mode, after kernel 5, and without tier 1 when
    ``resident_chunked_tier1`` is False."""
    args = jax_solver(tmp_path, "off")[0].args
    s, _ = port_tiers(args)
    assert getattr(s, "resident_contact_mode", None) is None
    assert s._resident_run.func is resident_affine_contact
    assert s._resident_fast.func is affine_chunked
    s.resident_chunked_tier1 = False
    s.prepare(args)
    assert s._resident_run.func is resident_affine_contact
    assert s._resident_fast is None


@pytest.mark.parametrize("case", ["bar_all", "bar_all_block"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tiers_match_jax_step_loop_on_the_bar(tmp_path, config, case):
    """The five tier configurations on the tet bar of
    ``tests/test_torch_emitters.py`` (tets_strain, tets_deformation_gradient
    and verts_bending on its curved surface, DEIM row form and block form):
    a contact-free window that tier 1 serves whole and certifies, then a
    10x gravity slam into the floor that the contact tier finishes, against
    the JAX package's ``pallas_mode="off"`` step loop on the same bases.
    Tolerances as above (P 1e-6, V 1e-4); measured at most 6.5e-14 in P
    and 2.3e-12 in V over the ten cases."""
    from test_torch_emitters import solvers

    switches, (tier1, contact) = CONFIGS[config]
    s, m, sj, mj = solvers(tmp_path, case, pallas_mode="off")
    s.resident_rebase_every = 4
    for k, v in switches.items():
        setattr(s, k, v)
    s.prepare(s.args)
    assert s._resident_run.func is contact
    f = gravity(m)
    ref = []
    for scale, steps in (FREE, SLAM):
        for _ in range(steps):
            sj.step(f * scale, num_iterations=ITERS)
        ref.append((mj.positions.copy(), mj.velocities.copy()))
    calls = spy_tier1(s) if tier1 is not None else None
    s.run_steps(f * FREE[0], FREE[1], num_iterations=ITERS)
    if tier1 is not None:
        assert calls == [FREE[1]] and s._last_fast_steps == FREE[1]
    _close(m, ref[0])
    s.run_steps(f * SLAM[0], SLAM[1], num_iterations=ITERS)
    assert s._last_fast_steps is None
    assert s.frame == FREE[1] + SLAM[1]
    assert m.positions[:, 1].min() > -0.5      # held at the floor
    assert m.positions[:, 1].min() < 0.05      # it reached the floor
    _close(m, ref[1])
