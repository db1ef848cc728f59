"""Kernels 3 and 4 of the PyTorch port (``animsnapbases_tpu_torch.ops.affine``)
against the JAX package's ``build_resident_affine`` (``contact_mode=False``
and ``True``) and ``build_resident_affine_exit`` in interpret mode, float64
on the CPU, on operands carried across by ``convert.operands_from_numpy``."""

import dataclasses

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch.convert import operands_from_numpy
from animsnapbases_tpu_torch.ops.affine import (
    AffineContext,
    affine_run_plain,
    resident_affine,
    resident_affine_contact,
    resident_affine_exit,
    resident_affine_exit_batched,
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
    f32_jax_operands,
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


def test_exit_batched_plain_matches_jax_interpret(tmp_path):
    """Kernel 4's batched build at nb = 3 (row 4b): sims 0 and 2 lifted
    FREE_LIFT under 2x and 4x gravity, sim 1 starting 0.1 above the floor
    under gravity, 30 steps with rebases every REBASE.  The whole batch
    stops before sim 1's first clamp: ``resident_affine_exit_batched`` on
    CPU tensors (the plain version on (3, 3, N)) gives the JAX kernel's
    steps_done, 0 < k < 30 (k = 1: the cloth's constraints throw sim 1 at
    the floor), and its P and V to 1e-9 (measured max |dP| 8.9e-15, |dV|
    4.9e-13 at |V| ~ 45) against ``build_resident_affine_exit(nb=3,
    interpret=True)``, whose state is dim-major (rows d * B + b); each sim
    equals the solo plain version run for k steps to 1e-12 (measured
    1.8e-15 in P, 6.0e-14 in V: the batched products sum in another
    order), and the solo version of sim 1 alone stops at the same k."""
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_affine_exit,
    )

    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    B, steps = 3, 30
    r = st["U_liftT"].shape[1]
    run = build_resident_affine_exit(
        *jax_common(s), model.floor_height, st["n_sel"],
        rebase_every=REBASE, interpret=True, nb=B, eta=s.eta)
    P, V, F = (np.stack(x) for x in zip(*(
        packed_state(s, model, lift, scale)
        for lift, scale in ((FREE_LIFT, 2.0), (CONTACT_LIFT, 1.0),
                            (FREE_LIFT, 4.0)))))

    def dim_major(x):                 # (B, 3, N) -> rows d * B + b
        return x.transpose(1, 0, 2).reshape(3 * B, -1)

    out_j = run(dim_major(P), dim_major(V), dim_major(F),
                np.zeros((1, 3 * B, r)), steps, ITERS)
    k_j = int(np.asarray(out_j[2])[0, 0])
    P_j, V_j = (np.asarray(x).reshape(3, B, -1).transpose(1, 0, 2)
                for x in out_j[:2])
    ao = port_affine(s, model)
    Pt, Vt, Ft = (torch.from_numpy(x) for x in (P, V, F))
    rb = torch.zeros(3, r, dtype=torch.float64)
    P_b, V_b, k = resident_affine_exit_batched(ao, Pt, Vt, Ft, rb, steps,
                                               ITERS, rebase_every=REBASE)
    assert k == k_j and 0 < k < steps
    np.testing.assert_allclose(P_b.numpy(), P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_b.numpy(), V_j, rtol=0, atol=1e-9)
    solo_k = [resident_affine_exit(ao, Pt[b], Vt[b], Ft[b], rb, steps,
                                   ITERS, rebase_every=REBASE)[2]
              for b in range(B)]
    assert solo_k[1] == k < min(solo_k[0], solo_k[2])
    for b in range(B):
        P_s, V_s, k_s = resident_affine_exit(ao, Pt[b], Vt[b], Ft[b], rb, k,
                                             ITERS, rebase_every=REBASE)
        assert k_s == k
        np.testing.assert_allclose(P_b[b].numpy(), P_s.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(V_b[b].numpy(), V_s.numpy(), rtol=0,
                                   atol=1e-12)


def test_exit_batched_refuses_a_solo_state(tmp_path):
    """The batched wrapper takes (B, 3, N) states only."""
    s, model = lean_jax_solver(tmp_path)
    _, _, _, _, port_in = _inputs(s, model, FREE_LIFT, 1.0)
    with pytest.raises(ValueError, match="B, 3, N"):
        resident_affine_exit_batched(port_affine(s, model), *port_in, 2,
                                     ITERS)


# contact mode: (force scale, steps, rebase_every, eta, initial y velocity)
# of each case
CONTACT_CASES = {
    # undamped; the rebases at 4, 8, 12 leave contact mode, and the cloth
    # re-enters it
    "reenter": (4.0, 14, REBASE, 1.0, 0.0),
    # eta = 0.8 (the scene's own damping is 0.07) from a downward throw:
    # the damping of Vy and of buVy in the recursion
    "damped": (4.0, 14, REBASE, 0.8, -2.0),
    # one stretch of 39 contact steps, no rebase
    "long": (4.0, 40, 64, None, 0.0),
}


@pytest.mark.parametrize("case", list(CONTACT_CASES))
def test_contact_mode_plain_matches_jax_interpret(tmp_path, case):
    """Kernel 3's contact-mode build against ``build_resident_affine(
    contact_mode=True)``: P and V to 1e-9 (measured max |dP| 3.1e-13,
    |dV| 1.0e-11 at |V| ~ 12 in the long case).  The steps' flags show
    the mode entered (3), carried (2) and, in the rebased cases, left at a
    rebase and entered again.  In the long case the recursions' ``buPy``
    and ``buVy`` are held to ``U^T A_c Py`` and ``U^T A_c Vy`` taken
    afresh, to 1e-9 of the latter's largest entry (measured 1.8e-14)."""
    from animsnapbases_tpu.ops.pallas_resident import build_resident_affine

    scale, steps, every, eta, vy = CONTACT_CASES[case]
    s, model = lean_jax_solver(tmp_path)
    eta = s.eta if eta is None else eta
    st = s._resident_state
    run = build_resident_affine(
        *jax_common(s)[:-1], s.dt, True, model.floor_height, st["n_sel"],
        rebase_every=every, interpret=True, contact_mode=True, eta=eta)
    P, V, F, rb, port_in = _inputs(s, model, CONTACT_LIFT, scale)
    V[1] = vy
    port_in[1][1] = vy
    P_j, V_j = (np.asarray(x) for x in run(P, V, F, rb, steps, ITERS))
    ao = port_affine(s, model)
    ao = dataclasses.replace(ao, res=dataclasses.replace(ao.res, eta=eta))
    ctx, state, flags = affine_run_plain(ao, *port_in, steps, ITERS,
                                         rebase_every=every,
                                         contact_mode=True)
    P_t, V_t = ctx.output(state)
    np.testing.assert_allclose(P_t.numpy(), P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_t.numpy(), V_j, rtol=0, atol=1e-9)
    # the mode: on from an entry (3) to the next rebase, each step in it 2
    mode = False
    for i, f in enumerate(flags.tolist()):
        mode = mode and not (i > 0 and i % every == 0)
        assert f == 2 if mode else f in (0, 3)
        mode = f in (2, 3)
    entries = flags.tolist().count(3)
    assert entries == 1 if case == "long" else entries >= 2
    if case == "long":
        for got, y in ((state.buPy, state.Py), (state.buVy, state.Vy)):
            want = ctx.project_y(y)
            assert float((got - want).abs().max()) <= \
                1e-9 * float(want.abs().max())
    # the wrapper on CPU tensors is the plain version
    P_w, V_w = resident_affine_contact(ao, *port_in, steps, ITERS,
                                       rebase_every=every)
    assert torch.equal(P_w, P_t) and torch.equal(V_w, V_t)


def test_contact_mode_bfloat16_storage_rounds_like_the_jax_kernel(tmp_path):
    """With bfloat16 storage (float32 state) the plain contact-mode build
    rounds ``corr_y``, ``u_y`` and the entry's ``wp_y``/``wv_y`` to
    bfloat16 where the JAX kernel does: 4 steps of the cloth resting on the
    floor, contact mode entered at step 0 (over anchors whose projections
    are still stale) and carried.  The two float32 versions sum in other
    orders (``pc`` in float64 here, float32 there), and one bfloat16 step
    of a coordinate moves P by ~4e-3 x |U w|, which sets the tolerance, as
    in tests/test_torch_affine_chunked.py (measured max |dP| 9.1e-6 at
    |P| ~ 9.5).  Past step 4 this scene's random bases amplify float32
    rounding ~100x in one step, in the lean build too, so the window stops
    there."""
    from animsnapbases_tpu.ops.pallas_resident import build_resident_affine

    s, model = lean_jax_solver(tmp_path)
    st = s._resident_state
    f32, Ul, Ua = f32_jax_operands(s)
    run = build_resident_affine(
        f32, st["ops"]["gather_slices"], st["ops"]["layout"], f32["G_allT"],
        f32["WT_all"], f32["inv3"], Ul, Ua,
        np.asarray(st["M_utac"], np.float32),
        np.asarray(st["U_selT"], np.float32),
        np.asarray(st["mass_inv"], np.float32), s.dt, True,
        model.floor_height, st["n_sel"], rebase_every=256, interpret=True,
        contact_mode=True, eta=s.eta)
    P, V, F = packed_state(s, model, 0.0, dtype=np.float32)
    r = st["U_liftT"].shape[1]
    P_j, _ = run(P, V, F, np.zeros((1, 3, r), np.float32), 4, ITERS)

    st_bf = dict(st, U_liftT=np.asarray(Ul, np.float64),
                 ut_acT=np.asarray(Ua, np.float64))
    _, ao = operands_from_numpy(
        st["ops"], "cpu", torch.float32, resident_state=st_bf,
        matmul_dtype=torch.bfloat16, dt=s.dt, eta=s.eta, floor=True,
        floor_h=model.floor_height, affine=True)
    ctx, state, flags = affine_run_plain(
        ao, *(torch.from_numpy(x) for x in (P, V, F)), torch.zeros(3, r), 4,
        ITERS, contact_mode=True)
    P_t, _ = ctx.output(state)
    assert ao.res.U_liftT.dtype == torch.bfloat16
    assert flags.tolist() == [3, 2, 2, 2]
    np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=0,
                               atol=1e-3)
