"""Kernel 2 of the PyTorch port (``animsnapbases_tpu_torch.ops.resident``)
against the JAX package's ``build_resident_multistep`` in interpret mode,
built as ``tests/test_damping.py`` builds it, with damping and the floor
on, float64 on the CPU, on operands carried across by
``convert.operands_from_numpy``."""

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch.convert import operands_from_numpy
from animsnapbases_tpu_torch.ops.resident import (
    resident_multistep,
    resident_multistep_plain,
)
from test_torch_fused_reduced import gravity, jax_solver


def _run_both(tmp_path, num_steps, num_iterations):
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_multistep,
    )

    s_jax, model = jax_solver(tmp_path, "interpret")
    st = s_jax._resident_state
    ops = st["ops"]
    run = build_resident_multistep(
        ops, ops["gather_slices"], ops["layout"], ops["G_allT"],
        ops["WT_all"], ops["inv3"], st["U_liftT"], st["ut_acT"],
        st["mass_inv"], s_jax.dt, model.floor_collision, model.floor_height,
        st["n_sel"], interpret=True, eta=s_jax.eta)
    perm, r = st["perm"], st["U_liftT"].shape[1]
    P = np.ascontiguousarray(model.positions[perm].T)
    V = np.ascontiguousarray(model.velocities[perm].T)
    F = np.ascontiguousarray(gravity(model)[perm].T)
    P_jax, V_jax = run(P, V, F, np.zeros((1, 3, r)), num_steps,
                       num_iterations)

    _, ro = operands_from_numpy(
        ops, "cpu", torch.float64, resident_state=st, dt=s_jax.dt,
        eta=s_jax.eta, floor=model.floor_collision,
        floor_h=model.floor_height)
    P_t, V_t = resident_multistep(
        ro, torch.from_numpy(P), torch.from_numpy(V), torch.from_numpy(F),
        torch.zeros(3, r, dtype=torch.float64), num_steps, num_iterations)
    return (np.asarray(P_jax), np.asarray(V_jax), P_t.numpy(), V_t.numpy(),
            model, ro)


def test_plain_matches_jax_interpret(tmp_path):
    """8 steps at 6 iterations, damping 0.07, floor on: P and V agree to
    1e-9 (measured max |dP| 4.2e-14, |dV| 1.1e-12 with |V| ~15)."""
    P_jax, V_jax, P, V, model, _ = _run_both(tmp_path, 8, 6)
    # the floor clamp fired: the bottom row started on the floor and
    # stays on it under gravity
    assert abs(P_jax[1].min() - model.floor_height) < 1e-3
    assert np.abs(V_jax).max() > 1.0
    np.testing.assert_allclose(P, P_jax, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V, V_jax, rtol=0, atol=1e-9)


@pytest.mark.parametrize("split", [(1, 7), (5, 3)])
def test_step_loop_composes(tmp_path, split):
    """Two calls of k and 8-k steps equal one call of 8 steps (static
    targets: every step reads the same rb_extra)."""
    _, _, P8, V8, _, ro = _run_both(tmp_path, 8, 6)
    s_jax, model = jax_solver(tmp_path, "interpret")
    perm, r = ro.perm, ro.fused.r
    P = torch.from_numpy(np.ascontiguousarray(model.positions[perm].T))
    V = torch.zeros_like(P)
    F = torch.from_numpy(np.ascontiguousarray(gravity(model)[perm].T))
    rb = torch.zeros(3, r, dtype=torch.float64)
    for k in split:
        P, V = resident_multistep_plain(ro, P, V, F, rb, k, 6)
    np.testing.assert_array_equal(P.numpy(), P8)
    np.testing.assert_array_equal(V.numpy(), V8)


def test_bfloat16_storage_rounds_like_the_jax_kernel(tmp_path):
    """With bfloat16 storage the plain version rounds sn and u to bfloat16
    before they meet the matrices, as the JAX kernel does: float32 state,
    bfloat16 matrices, 4 steps.  The two float32 loops sum in other orders,
    so a value near a bfloat16 rounding boundary can round the other way
    in one package: one bfloat16 step (2^-8 relative) of u moves P by
    ~4e-3 x |U u|, which sets the tolerance (measured max |dP| 1.4e-4 at
    |P| ~10; a plain version that skipped the storage rounding was
    measured 7.1e-3 off)."""
    import jax.numpy as jnp

    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_multistep,
    )

    s_jax, model = jax_solver(tmp_path, "interpret")
    st = s_jax._resident_state
    ops = st["ops"]
    f32 = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray)
               and v.dtype == np.float64 else v) for k, v in ops.items()}
    f32["flat_arrays"] = [np.asarray(a, np.float32)
                          for a in ops["flat_arrays"]]
    Ul = np.asarray(jnp.asarray(st["U_liftT"], jnp.bfloat16))
    Ua = np.asarray(jnp.asarray(st["ut_acT"], jnp.bfloat16))
    run = build_resident_multistep(
        f32, ops["gather_slices"], ops["layout"], f32["G_allT"],
        f32["WT_all"], f32["inv3"], Ul, Ua,
        np.asarray(st["mass_inv"], np.float32), s_jax.dt,
        model.floor_collision, model.floor_height, st["n_sel"],
        interpret=True, eta=s_jax.eta)
    perm, r = st["perm"], st["U_liftT"].shape[1]
    P = np.ascontiguousarray(model.positions[perm].T).astype(np.float32)
    V = np.zeros_like(P)
    F = np.ascontiguousarray(gravity(model)[perm].T).astype(np.float32)
    P_jax, _ = run(P, V, F, np.zeros((1, 3, r), np.float32), 4, 6)

    st_bf = dict(st, U_liftT=np.asarray(Ul, np.float64),
                 ut_acT=np.asarray(Ua, np.float64))
    _, ro = operands_from_numpy(
        ops, "cpu", torch.float32, resident_state=st_bf,
        matmul_dtype=torch.bfloat16, dt=s_jax.dt, eta=s_jax.eta,
        floor=model.floor_collision, floor_h=model.floor_height)
    P_t, _ = resident_multistep(
        ro, torch.from_numpy(P), torch.from_numpy(V), torch.from_numpy(F),
        torch.zeros(3, r), 4, 6)
    assert ro.U_liftT.dtype == torch.bfloat16
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_jax), rtol=0,
                               atol=1e-3)
