"""Kernels 3 and 4 of the PyTorch port (``animsnapbases_tpu_torch.ops.affine``)
against the JAX package's ``build_resident_affine(contact_mode=False)`` and
``build_resident_affine_exit`` in interpret mode (``rebase_every=4``),
float64 on the CPU, on operands carried across by
``convert.operands_from_numpy``."""

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch.ops.affine import (
    AffineContext,
    resident_affine,
    resident_affine_exit,
)
from animsnapbases_tpu_torch.ops.resident import (
    force_term,
    resident_multistep_plain,
)
from test_torch_affine_chunked import (
    CONTACT_LIFT,
    FREE_LIFT,
    ITERS,
    REBASE,
    jax_common,
    lean_jax_solver,
    packed_state,
    port_affine,
)


def _inputs(s, model, lift, scale):
    P, V, F = packed_state(s, model, lift, scale)
    r = s._resident_state["U_liftT"].shape[1]
    return (P, V, F, np.zeros((1, 3, r)),
            [torch.from_numpy(x) for x in (P, V, F)]
            + [torch.zeros(3, r, dtype=torch.float64)])


@pytest.mark.parametrize("floor", [True, False])
def test_lean_plain_matches_jax_interpret(tmp_path, floor):
    """Kernel 3, lean build: 14 steps under 4x gravity from 0.1 above the
    floor, across three rebases; with the floor on the contact tail fires
    and re-anchors, with it off every step is free.  P and V to 1e-9
    (measured max |dP| 4.1e-14, |dV| 1.3e-12, |V| ~ 8)."""
    from animsnapbases_tpu.ops.pallas_resident import build_resident_affine

    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    run = build_resident_affine(
        *jax_common(s)[:-1], s.dt, floor, model.floor_height, st["n_sel"],
        rebase_every=REBASE, interpret=True, contact_mode=False, eta=s.eta)
    P, V, F, rb, port_in = _inputs(s, model, CONTACT_LIFT, 4.0)
    P_j, V_j = (np.asarray(x) for x in run(P, V, F, rb, 14, ITERS))
    ao = port_affine(s, model, floor=floor)
    P_t, V_t = resident_affine(ao, *port_in, 14, ITERS, rebase_every=REBASE)
    # the clamp held the cloth at the floor; without it, it falls through
    assert (P_j[1].min() > -0.05) if floor else (P_j[1].min() < -0.5)
    np.testing.assert_allclose(P_t.numpy(), P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_t.numpy(), V_j, rtol=0, atol=1e-9)


def test_lean_contact_step_is_the_standard_step(tmp_path):
    """A contacting step of kernel 3 is the standard step: from a state on
    the floor, one lean step equals one step of kernel 2's plain version
    (the affine form re-associates only the materialization)."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    _, _, _, _, (P, V, F, rb) = _inputs(s, model, 0.0, 1.0)
    ctx = AffineContext(ao, force_term(ao.res, F))
    st = ctx.init_anchors(P, V)
    _, _, _, _, _, asn, wsn = ctx.predictor(st)
    assert bool((ctx.y_predictor(st, asn, wsn) < 0).any())   # it clamps
    P_a, V_a = resident_affine(ao, P, V, F, rb, 1, ITERS)
    P_s, V_s = resident_multistep_plain(ao.res, P, V, F, rb, 1, ITERS)
    np.testing.assert_allclose(P_a.numpy(), P_s.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(V_a.numpy(), V_s.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", ["free", "contact"])
def test_exit_plain_matches_jax_interpret(tmp_path, case):
    """Kernel 4: 10 contact-free steps across two rebases (steps_done 10),
    and a contacting run that stops at the same 0 < steps_done < 30.  P and
    V to 1e-9 (measured max |dP| 5.3e-15, |dV| 4.3e-13)."""
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_affine_exit,
    )

    lift, scale, steps = {"free": (FREE_LIFT, 1.0, 10),
                          "contact": (CONTACT_LIFT, 4.0, 30)}[case]
    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    run = build_resident_affine_exit(
        *jax_common(s), model.floor_height, st["n_sel"],
        rebase_every=REBASE, interpret=True, eta=s.eta)
    P, V, F, rb, port_in = _inputs(s, model, lift, scale)
    P_j, V_j, k_j = run(P, V, F, rb, steps, ITERS)
    k_j = int(np.asarray(k_j)[0, 0])
    ao = port_affine(s, model)
    P_t, V_t, k_t = resident_affine_exit(ao, *port_in, steps, ITERS,
                                         rebase_every=REBASE)
    assert k_t == k_j
    assert (0 < k_j < steps) if case == "contact" else k_j == steps
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), rtol=0,
                               atol=1e-9)


def test_contact_mode_is_not_ported(tmp_path):
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    _, _, _, _, port_in = _inputs(s, model, FREE_LIFT, 1.0)
    with pytest.raises(NotImplementedError, match="Queue B"):
        resident_affine(ao, *port_in, 2, ITERS, contact_mode=True)
