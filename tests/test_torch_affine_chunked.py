"""Kernel 5 of the PyTorch port (``animsnapbases_tpu_torch.ops.affine_chunked``)
against the JAX package's ``build_resident_affine_chunked`` in interpret mode
(``rebase_every=4``, its default build options), float64 on the CPU, on
operands carried across by ``convert.operands_from_numpy``.

Also home of the helpers the affine tests share: the JAX solver of the small
scene with ``resident_contact_mode=False`` and its operands on both sides,
in float64 and, for the bfloat16-storage cases, in float32.
"""

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch.convert import operands_from_numpy
from animsnapbases_tpu_torch.ops.affine import NO_FLOOR
from animsnapbases_tpu_torch.ops.affine_chunked import (
    affine_chunked,
    affine_chunked_plain,
)
from test_torch_fused_reduced import gravity, jax_solver

REBASE = 4
ITERS = 6
# the small scene's cloth spans y in [0, 9] with its bottom row on the
# floor: lifted by FREE_LIFT it stays clear for the contact-free windows;
# lifted by CONTACT_LIFT under 4x gravity it reaches the floor in a few
# steps
FREE_LIFT = 3.0
CONTACT_LIFT = 0.1


def lean_jax_solver(tmp_path):
    """The JAX interpret-mode solver of the small scene, prepared with
    ``resident_contact_mode=False`` (the lean build)."""
    s, model = jax_solver(tmp_path, "interpret")
    s.resident_contact_mode = False
    s.set_dirty()
    s.prepare(s.args)
    return s, model


def jax_common(s):
    """The positional arguments of the JAX affine builders, from the
    solver's prepared resident state (tests/test_resident_kernel.py
    ``_tier1_pair``)."""
    st = s._resident_state
    ops = st["ops"]
    return (ops, ops["gather_slices"], ops["layout"], ops["G_allT"],
            ops["WT_all"], ops["inv3"], st["U_liftT"], st["ut_acT"],
            st["M_utac"], st["U_selT"], st["mass_inv"], s.dt)


def port_affine(s, model, floor=True, dtype=torch.float64, **kw):
    st = s._resident_state
    _, ao = operands_from_numpy(
        st["ops"], "cpu", dtype, resident_state=st, dt=s.dt, eta=s.eta,
        floor=floor, floor_h=model.floor_height, affine=True, **kw)
    return ao


def packed_state(s, model, lift, force_scale=1.0, dtype=np.float64):
    """Permuted (3, N) P, V, fext of the model lifted by ``lift``."""
    perm = s._resident_state["perm"]
    P = model.positions.copy()
    P[:, 1] += lift
    F = gravity(model) * force_scale
    return tuple(np.ascontiguousarray(x[perm].T).astype(dtype)
                 for x in (P, np.zeros_like(P), F))


def f32_jax_operands(s):
    """The JAX solver's prepared operands for a float32 kernel with
    bfloat16 storage -> (float32 ops, U_liftT, ut_acT), the two matrices
    rounded to bfloat16."""
    import jax.numpy as jnp

    st = s._resident_state
    ops = st["ops"]
    f32 = {k: (np.asarray(v, np.float32) if isinstance(v, np.ndarray)
               and v.dtype == np.float64 else v) for k, v in ops.items()}
    f32["flat_arrays"] = [np.asarray(a, np.float32)
                          for a in ops["flat_arrays"]]
    return (f32, np.asarray(jnp.asarray(st["U_liftT"], jnp.bfloat16)),
            np.asarray(jnp.asarray(st["ut_acT"], jnp.bfloat16)))


def run_both(tmp_path, lift, force_scale, steps, floor=True):
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_affine_chunked,
    )

    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    floor_h = model.floor_height if floor else NO_FLOOR
    run = build_resident_affine_chunked(
        *jax_common(s), floor_h, st["n_sel"], rebase_every=REBASE,
        interpret=True, eta=s.eta)
    P, V, F = packed_state(s, model, lift, force_scale)
    r = st["U_liftT"].shape[1]
    P_j, V_j, k_j = run(P, V, F, np.zeros((1, 3, r)), steps, ITERS)
    ao = port_affine(s, model, floor=floor)
    P_t, V_t, k_t = affine_chunked(
        ao, *(torch.from_numpy(x) for x in (P, V, F)),
        torch.zeros(3, r, dtype=torch.float64), steps, ITERS,
        rebase_every=REBASE)
    return (np.asarray(P_j), np.asarray(V_j), int(np.asarray(k_j)[0, 0]),
            P_t.numpy(), V_t.numpy(), k_t, P)


@pytest.mark.parametrize("case", ["free", "contact", "floor_off"])
def test_plain_matches_jax_interpret(tmp_path, case):
    """Contact-free 10 steps across two rebases (k = 10); a contacting run
    under 4x gravity from 0.1 above the floor (both exit at the same
    0 < k < 30); the floor off with the same contacting state (never
    exits).  P and V to 1e-9: measured max |dP| 1.6e-13, |dV| 5.2e-12
    (floor off, |V| ~ 6; |V| reaches 45 in the contacting run)."""
    lift, scale, steps, floor = {
        "free": (FREE_LIFT, 1.0, 10, True),
        "contact": (CONTACT_LIFT, 4.0, 30, True),
        "floor_off": (CONTACT_LIFT, 4.0, 12, False)}[case]
    P_j, V_j, k_j, P_t, V_t, k_t, P0 = run_both(tmp_path, lift, scale,
                                               steps, floor)
    assert k_t == k_j
    if case == "contact":
        assert 0 < k_j < steps
    else:
        assert k_j == steps
    if case == "floor_off":
        assert P_j[1].min() < 0.0        # it crossed the floor plane
    assert np.abs(P_j - P0).max() > 0.1  # the cloth moved
    np.testing.assert_allclose(P_t, P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_t, V_j, rtol=0, atol=1e-9)


def test_chunks_compose(tmp_path):
    """The outer loop's chunking is the rebase cadence: one chunk of 8 steps
    and four of 2 differ only by the re-anchoring's rounding (float64),
    and every chunk's k adds up."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    P, V, F = (torch.from_numpy(x)
               for x in packed_state(s, model, FREE_LIFT))
    rb = torch.zeros(3, ao.fused.r, dtype=torch.float64)
    P8, V8, k8 = affine_chunked_plain(ao, P, V, F, rb, 8, ITERS,
                                      rebase_every=8)
    P2, V2, k2 = affine_chunked_plain(ao, P, V, F, rb, 8, ITERS,
                                      rebase_every=2)
    assert k8 == k2 == 8
    np.testing.assert_allclose(P2.numpy(), P8.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(V2.numpy(), V8.numpy(), rtol=0, atol=1e-9)


def test_bfloat16_storage_rounds_like_the_jax_kernel(tmp_path):
    """With bfloat16 storage (float32 state) the plain chunk rounds the
    reduced coordinates and the projected anchors to bfloat16 where the JAX
    kernel and its outer loop do: 5 contact-free steps across two rebases
    (``rebase_every=2``).  As in tests/test_torch_resident.py, the two
    float32 loops sum in other orders and one bfloat16 step of a
    coordinate moves P by ~4e-3 x |U w|, which sets the tolerance
    (measured max |dP| 9.5e-7 at |P| ~12, |V| ~50).  Past step 5 this
    scene's random bases amplify float32 rounding ~1e3x in one step
    (the sixth step parts the two packages by 3e-4 with or without a
    rebase), so the window stops there."""
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_affine_chunked,
    )

    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    ops = st["ops"]
    f32, Ul, Ua = f32_jax_operands(s)
    run = build_resident_affine_chunked(
        f32, ops["gather_slices"], ops["layout"], f32["G_allT"],
        f32["WT_all"], f32["inv3"], Ul, Ua,
        np.asarray(st["M_utac"], np.float32),
        np.asarray(st["U_selT"], np.float32),
        np.asarray(st["mass_inv"], np.float32), s.dt, model.floor_height,
        st["n_sel"], rebase_every=2, interpret=True, eta=s.eta)
    P, V, F = packed_state(s, model, FREE_LIFT, dtype=np.float32)
    r = st["U_liftT"].shape[1]
    P_j, _, k_j = run(P, V, F, np.zeros((1, 3, r), np.float32), 5, ITERS)

    st_bf = dict(st, U_liftT=np.asarray(Ul, np.float64),
                 ut_acT=np.asarray(Ua, np.float64))
    _, ao = operands_from_numpy(
        ops, "cpu", torch.float32, resident_state=st_bf,
        matmul_dtype=torch.bfloat16, dt=s.dt, eta=s.eta, floor=True,
        floor_h=model.floor_height, affine=True)
    P_t, _, k_t = affine_chunked(
        ao, *(torch.from_numpy(x) for x in (P, V, F)), torch.zeros(3, r),
        5, ITERS, rebase_every=2)
    assert ao.res.U_liftT.dtype == torch.bfloat16
    assert k_t == int(np.asarray(k_j)[0, 0]) == 5
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-3)
