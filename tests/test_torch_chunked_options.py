"""Kernel 5's build options in the PyTorch port
(``animsnapbases_tpu_torch.ops.affine_chunked.ChunkOptions``): the plain
version of each build against the JAX package's
``build_resident_affine_chunked`` with the same keyword in interpret mode,
at nb = 1 and nb = 3, float64 on the CPU, ``rebase_every=4``, on operands
carried across by ``convert.operands_from_numpy``
(``tests/test_torch_affine_chunked.py``'s setup); the builds against each
other; the solver's switches (``resident_floor_bound_skip``,
``resident_floor_exact``, ``resident_chunked_opts``) and ``run_steps`` /
``make_batched_run`` on the exact-free build against the JAX solver.

The windows: floor-clear, the small scene lifted 10 units under gravity for
10 steps (lifted 3, as the other tier-1 tests lift it, the exact-free
build's bound trips at step 2: 1.25 ||wsn_y|| umax outgrows the 3-unit gap
once the reduced coordinates move); near the floor, lifted 1 unit under 4x
gravity for 30 steps, where the exact build stops at step 9 and the
exact-free build after 1.
"""

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch.ops import affine_chunked as k5
from animsnapbases_tpu_torch.ops.affine_chunked import (
    BUILDS,
    DEFAULT_OPTIONS,
    ChunkOptions,
    affine_chunked_plain,
)
from test_torch_affine_chunked import (
    ITERS,
    REBASE,
    jax_common,
    lean_jax_solver,
    packed_state,
    port_affine,
)
from test_torch_batched import ensemble, jax_lifted
from test_torch_fused_reduced import gravity, jax_solver
from test_torch_tiers import port_tiers

# (lift, gravity scale, steps) of the two windows
FREE = (10.0, 1.0, 10)
NEAR = (1.0, 4.0, 30)
FLAGS = {
    "exact_free": {"floor_exact": False},
    "bound_off": {"floor_bound_skip": False},
    "fold_off": {"fold_vc": False},
    "sqrt_bound": {"sqrt_free_bound": False},
    "static_off": {"static_rb": False},
}


def _states(s, model, windows):
    """(P, V, F) (B, 3, N) float64 numpy: sim b in ``windows[b]``."""
    states = [packed_state(s, model, lift, scale)
              for lift, scale, _ in windows]
    return tuple(np.stack(x) for x in zip(*states))


def _jax_run(s, model, flags, P, V, F, steps):
    """The JAX interpret-mode chunked kernel with ``flags`` on the
    (B, 3, N) states -> (P', V') (B, 3, N) and k."""
    from animsnapbases_tpu.ops.pallas_resident import (
        build_resident_affine_chunked,
    )

    nb = P.shape[0]
    st = s._resident_state
    run = build_resident_affine_chunked(
        *jax_common(s), model.floor_height, st["n_sel"],
        rebase_every=REBASE, interpret=True, eta=s.eta, nb=nb, **flags)

    def dim_major(x):                                    # rows d * B + b
        return np.ascontiguousarray(x.transpose(1, 0, 2).reshape(3 * nb, -1))

    r = st["U_liftT"].shape[1]
    out = run(dim_major(P), dim_major(V), dim_major(F),
              np.zeros((1, 3 * nb, r)), steps, ITERS)
    P_j, V_j = (np.asarray(x).reshape(3, nb, -1).transpose(1, 0, 2)
                for x in out[:2])
    return P_j, V_j, int(np.asarray(out[2])[0, 0])


def _port_run(ao, options, P, V, F, steps):
    """The port's plain kernel 5 in the build of ``options`` on (B, 3, N)
    tensors (B = 1: the solo call) -> (P', V') (B, 3, N) and k."""
    rb = torch.zeros(3, ao.fused.r, dtype=torch.float64)
    if P.shape[0] == 1:
        P_t, V_t, k = affine_chunked_plain(ao, P[0], V[0], F[0], rb, steps,
                                           ITERS, rebase_every=REBASE,
                                           options=options)
        return P_t[None], V_t[None], k
    return affine_chunked_plain(ao, P, V, F, rb, steps, ITERS,
                                rebase_every=REBASE, options=options)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_plain_build_matches_jax_interpret(tmp_path, flag, nb):
    """Each build against the JAX kernel with the same keyword: at nb = 1
    near the floor (the bound trips; the exact check runs every step
    without the bound; the exact-free build stops at the trip), at nb = 3
    on a batch of a floor-clear sim, a sim near the floor and a floor-clear
    sim at 1.3x gravity (whole-batch exit).  The same k; P and V to 1e-9
    (measured at most ~1e-13 and ~1e-12, as the default build in
    tests/test_torch_affine_chunked.py)."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    windows = [NEAR] if nb == 1 else [FREE, NEAR, (FREE[0], 1.3, FREE[2])]
    steps = NEAR[2]
    P, V, F = _states(s, model, windows)
    P_j, V_j, k_j = _jax_run(s, model, FLAGS[flag], P, V, F, steps)
    options = ChunkOptions(**FLAGS[flag])
    P_t, V_t, k_t = _port_run(ao, options, *(torch.from_numpy(x)
                                             for x in (P, V, F)), steps)
    assert k_t == k_j
    assert 0 < k_j < steps                   # the window reached the floor
    assert np.abs(P_j - P).max() > 0.01      # the cloth moved
    np.testing.assert_allclose(P_t.numpy(), P_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(V_t.numpy(), V_j, rtol=0, atol=1e-9)


@pytest.mark.parametrize("build", BUILDS, ids=lambda b: b.label or "default")
def test_builds_agree_bit_for_bit_on_a_floor_clear_window(tmp_path, build):
    """On the floor-clear window the bound clears every step, so the
    decision of a step is the only thing a build changes: every build equals
    the build of the same ``fold_vc`` with the other options on bit for bit
    (the exact-free build the exact one, as the JAX
    test_chunked_floor_exact_free_matches_contact_free has it), at nb = 1
    and nb = 3, and the ``fold_vc=False`` builds agree with the default to
    1e-9 (the gathered values summed in another order)."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    base = ChunkOptions(fold_vc=build.fold_vc)
    for windows in ([FREE], [FREE, (FREE[0], 1.15, 0), (FREE[0], 1.3, 0)]):
        P, V, F = (torch.from_numpy(x) for x in _states(s, model, windows))
        got = _port_run(ao, build, P, V, F, FREE[2])
        want = _port_run(ao, base, P, V, F, FREE[2])
        default = _port_run(ao, DEFAULT_OPTIONS, P, V, F, FREE[2])
        assert got[2] == want[2] == default[2] == FREE[2]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        np.testing.assert_allclose(got[0].numpy(), default[0].numpy(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[1].numpy(), default[1].numpy(),
                                   rtol=0, atol=1e-9)


def _chunks(ao, options, P, V, F, steps, monkeypatch):
    """Every chunk's (ap, av, wp, wv, k) of :func:`_port_run`, in order."""
    seen, real = [], k5.affine_chunk_plain

    def chunk(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out

    with monkeypatch.context() as m:
        m.setattr(k5, "affine_chunk_plain", chunk)
        _port_run(ao, options, P, V, F, steps)
    return seen


@pytest.mark.parametrize(
    "build", [b for b in BUILDS if b.floor_exact and b.floor_bound_skip],
    ids=lambda b: b.label or "default")
def test_exact_builds_keep_their_outputs_with_the_interval_bound(
        tmp_path, build, monkeypatch):
    """The exact builds with the bound give every chunk's (ap, av, wp, wv,
    k) bit for bit as the floor test without the interval bound (the
    Cauchy-Schwarz bound alone, as before it) gives them, on the
    near-floor and floor-clear windows and on a batch of both, nb = 3: the
    exact row decides the stop, and the interval bound only whether it is
    computed."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    for windows in ([NEAR], [FREE], [FREE, NEAR, FREE]):
        P, V, F = (torch.from_numpy(x) for x in _states(s, model, windows))
        got = _chunks(ao, build, P, V, F, NEAR[2], monkeypatch)
        with monkeypatch.context() as m:
            m.setattr(k5, "interval_clears", lambda ao, lb_aff, *a:
                      torch.zeros_like(lb_aff, dtype=torch.bool))
            want = _chunks(ao, build, P, V, F, NEAR[2], monkeypatch)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g[4] == w[4]
            assert all(torch.equal(x, y) for x, y in zip(g[:4], w[:4]))


@pytest.mark.parametrize("nb", [1, 3])
def test_exact_free_exits_conservatively(tmp_path, nb):
    """Near the floor the exact-free build stops at or before the exact
    build's first clamped step (the interval bound is conservative), and
    what it committed is the exact build run to that step, bit for bit
    (the JAX test_chunked_floor_exact_free_exits_conservatively); at nb = 3
    for the whole batch."""
    s, model = lean_jax_solver(tmp_path)
    ao = port_affine(s, model)
    windows = [NEAR] if nb == 1 else [FREE, NEAR, FREE]
    P, V, F = (torch.from_numpy(x) for x in _states(s, model, windows))
    free = ChunkOptions(floor_exact=False)
    _, _, k_e = _port_run(ao, DEFAULT_OPTIONS, P, V, F, NEAR[2])
    P_f, V_f, k_f = _port_run(ao, free, P, V, F, NEAR[2])
    assert 0 < k_e < NEAR[2]
    assert 0 < k_f <= k_e
    P_e, V_e, k_e2 = _port_run(ao, DEFAULT_OPTIONS, P, V, F, k_f)
    assert k_e2 == k_f
    assert torch.equal(P_f, P_e) and torch.equal(V_f, V_e)


def test_options_interlock_and_switches(tmp_path):
    """``floor_exact=False`` needs the bound (ValueError, as the JAX
    assert); the solver resolves its switches as the JAX
    ``_chunked_floor_exact`` does: an explicit ``resident_floor_exact`` is
    obeyed, ``resident_floor_bound_skip=False`` forces the exact build, None
    follows ``CHUNKED_EXACT_FREE_MIN_VERTS``; ``resident_chunked_opts``
    passes its keywords to the build, and an unknown one raises
    ``TypeError`` at ``prepare()``.  With the class's threshold the small
    scene's 100 vertices take the exact build."""
    with pytest.raises(ValueError, match="requires the certified floor"):
        ChunkOptions(floor_bound_skip=False, floor_exact=False)
    assert ChunkOptions(floor_bound_skip=False, sqrt_free_bound=False) \
        .build() == ChunkOptions(floor_bound_skip=False)
    args = jax_solver(tmp_path, "off")[0].args
    s, _ = port_tiers(args)
    n = s.model.n_verts
    assert s._chunk_opts == DEFAULT_OPTIONS
    assert s._resident_fast.keywords["options"] == DEFAULT_OPTIONS
    gate = type(s).CHUNKED_EXACT_FREE_MIN_VERTS      # the H100's threshold
    assert s._chunked_floor_exact(gate) is False
    assert s._chunked_floor_exact(gate - 1) is True
    s.CHUNKED_EXACT_FREE_MIN_VERTS = None            # exact at every size
    assert s._chunked_floor_exact(10 ** 9) is True
    s.CHUNKED_EXACT_FREE_MIN_VERTS = n
    assert s._chunked_floor_exact(n) is False
    assert s._chunked_floor_exact(n - 1) is True
    s.resident_floor_exact = True
    assert s._chunked_floor_exact(n) is True
    s.resident_floor_exact = False
    assert s._chunked_floor_exact(1) is False
    s.resident_floor_bound_skip = False          # interlock: bound off
    assert s._chunked_floor_exact(1) is True
    s.resident_chunked_opts = {"fold_vc": False, "sqrt_free_bound": False}
    s.prepare(args)
    want = ChunkOptions(floor_bound_skip=False, fold_vc=False,
                        sqrt_free_bound=False)
    assert s._chunk_opts == want
    assert s._resident_fast.keywords["options"] == want
    s.resident_chunked_opts = {"fold_vc": False, "bogus": 1}
    with pytest.raises(TypeError, match="bogus"):
        s.prepare(args)


def test_run_steps_exact_free_matches_jax(tmp_path):
    """``run_steps`` on the exact-free build (``resident_floor_exact =
    False``, ``CHUNKED_TIER1_MIN_VERTS = 4`` on both sides: kernel 5 as tier
    1, kernel 2 as the contact tier) against the JAX solver's ``run_steps``
    on the same switches in interpret mode, through the tier tests' 10-step
    window 3 units above the floor and a 20-step slam at 10x gravity.  In
    the first the bound trips (at steps 2, 1 and 2 of three calls), where
    the exact build certifies all 10 in one: the recursion rebases,
    re-enters and serves the window on tier 1 (the last call certified on
    both sides); in the slam bound trips exit to a rebase
    and re-entry or to the contact tier, never skipping or doubling a step.
    The JAX test's 50x slam is chaotic in float64 on this scene with either
    build (ROADMAP Queue C).  P to 1e-6, V to 1e-4, the JAX test's
    tolerances (measured ~1e-13 and ~1e-12)."""
    args = jax_solver(tmp_path, "off")[0].args
    switches = {"CHUNKED_TIER1_MIN_VERTS": 4, "resident_floor_exact": False,
                "resident_rebase_every": 4}
    s_j, m_j = jax_lifted(args, "interpret", **switches)
    assert s_j._resident_fast_kind == "chunked"
    s, m = port_tiers(args, **switches)
    assert s._resident_kind == "standard"
    assert s._chunk_opts == ChunkOptions(floor_exact=False)
    f = gravity(m)
    calls = []
    fast = s._resident_fast

    def spy(*a, **kw):
        out = fast(*a, **kw)
        calls.append(out[2])
        return out

    s._resident_fast = spy
    for scale, steps in ((1.0, 10), (10.0, 20)):
        s_j.run_steps(f * scale, steps, num_iterations=ITERS)
        s.run_steps(f * scale, steps, num_iterations=ITERS)
        if scale == 1.0:
            assert sum(calls) == steps and len(calls) > 1
            assert s._last_fast_steps == s_j._last_fast_steps == calls[-1]
        np.testing.assert_allclose(m.positions, m_j.positions, atol=1e-6)
        np.testing.assert_allclose(m.velocities, m_j.velocities, atol=1e-4)
    assert s._last_fast_steps is None and s.frame == s_j.frame == 30
    assert len(calls) > 4 and calls[-1] < 20     # the slam exited tier 1
    assert m.positions[:, 1].min() > -0.5        # held at the floor
    assert m.positions[:, 1].min() < 0.05        # it reached the floor


def test_batched_run_exact_free_matches_jax(tmp_path):
    """``make_batched_run`` on the exact-free large-model route (batched
    kernel 5 in its exact-free build, windows on batched kernel 2) against
    the JAX ``make_batched_run`` on the same switches in interpret mode: one
    sim slammed at 10x gravity, one floor-clear, 20 steps with chunks of
    2.  P to 1e-6, V to 1e-4."""
    args = jax_solver(tmp_path, "off")[0].args
    switches = {"CHUNKED_TIER1_MIN_VERTS": 4, "resident_floor_exact": False,
                "resident_rebase_every": 2}
    s_j, m_j = jax_lifted(args, "interpret", **switches)
    # the JAX solver takes its batched chunked route where the full-state
    # batched kernel is refused (tests/test_resident_batched.py does so too)
    s_j._build_resident_batched = lambda nb: None
    pos, vel, fs = ensemble(m_j, [1.0, 10.0])
    p_j, v_j = (np.asarray(x) for x in s_j.make_batched_run()(
        pos, vel, fs, 20, num_iterations=ITERS))
    assert s_j._last_batched_path.startswith("batched-chunked")
    s, _ = port_tiers(args, **switches)
    p, v = s.make_batched_run()(pos, vel, fs, 20, num_iterations=ITERS)
    assert s._last_batched_path.startswith("batched-chunked+perstep")
    assert p[1, :, 1].min() > -0.5               # held at the floor
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-4)
