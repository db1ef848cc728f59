"""The port's spans and counters (``animsnapbases_tpu_torch/utils/
profiling.py``) on the CPU: the gated ``annotate``, the ``asb.*`` spans of
``run_steps`` and ``make_batched_run`` as they nest, the launch counters in
``counters()``, the transfer bytes of a call, and the plain versions'
counts of kernel 5's exact checks and of kernel 3's contact-mode steps.
The tests marked ``card`` hold the device counters against the plain
versions' counts and the kernels' outputs with and without the counters'
block; they skip without a card (on a machine without JAX: ``python3 -m
pytest --noconftest tests/test_torch_tracing.py -m card``).  No JAX
here."""

import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from animsnapbases_tpu_torch.ops import affine as k3
from animsnapbases_tpu_torch.ops import affine_chunked as k5
from animsnapbases_tpu_torch.sim.model import DeformableModel
from animsnapbases_tpu_torch.utils import profiling
from animsnapbases_tpu_torch.utils.synthetic import synthetic_reduced_solver

STEPS = 12


def small_solver(device="cpu", dtype=torch.float32, **attrs):
    """chip_smoke.py's small cloth (r = 8, 6 DEIM rows a group), prepared
    again with the solver attributes ``attrs``."""
    model = cs.small_scene(DeformableModel, cloth_model)
    with tempfile.TemporaryDirectory() as tmp:
        pos = cs.free_position_basis(model, 8, os.path.join(tmp, "free.npz"))
        s = synthetic_reduced_solver(
            model, K=6, r=8, work_dir=tmp, device=device, dtype=dtype,
            extra_args={"damping": 0.07, "position_basis_file": pos})
        for k, v in attrs.items():
            setattr(s, k, v)
        s.set_dirty()
        s.prepare(s.args)
    return model, s


@pytest.fixture(scope="module")
def small():
    return small_solver(resident_rebase_every=4)


def lifted(model, lift):
    P = model.init_positions.copy()
    P[:, 1] += lift
    return P


def traced(fn):
    """The ``asb.*`` spans recorded while ``fn()`` runs under a CPU
    profiler: [(start us, end us, name)], sorted."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("asb."))


def parent(spans, child):
    """The innermost span that holds ``child``, or None."""
    a, b, _ = child
    holders = [s for s in spans if s is not child and s[0] <= a
               and b <= s[1]]
    return max(holders, key=lambda s: (s[0], -s[1]))[2] if holders else None


def parents(spans):
    """{span name: the set of names of its innermost holders}."""
    out = {}
    for s in spans:
        out.setdefault(s[2], set()).add(parent(spans, s))
    return out


def change(fn):
    before = profiling.counters()
    fn()
    after = profiling.counters()
    return {k: v - before[k] for k, v in after.items()}


def test_annotate_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.annotate("asb.x"), profiling.annotate("asb.y")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.annotate("asb.x") is not a


def test_run_steps_spans_nest_as_listed(small):
    """Tier 1 serves the free window: the transfers, the host check and
    tier 1 inside ``asb.run_steps``, the outer loop's stages of a chunk
    inside ``asb.tier1`` (the plain chunk has no launch or read-back); a
    window that reaches the floor adds the contact tier after the recursion
    (its own ``asb.run_steps``)."""
    model, s = small
    f = cs.gravity(model)

    def free():
        model.positions, model.velocities = lifted(model, 3.0), np.zeros_like(
            model.positions)
        s.run_steps(f, STEPS, num_iterations=4)

    spans = traced(free)
    assert s._last_fast_steps == STEPS
    got = parents(spans)
    assert got == {"asb.run_steps": {None},
                   "asb.to_device": {"asb.run_steps"},
                   "asb.host_check": {"asb.run_steps"},
                   "asb.tier1": {"asb.run_steps"},
                   "asb.chunk.operands": {"asb.tier1"},
                   "asb.chunk.advance": {"asb.tier1"},
                   "asb.to_host": {"asb.run_steps"}}
    names = [n for _, _, n in spans]
    assert names.count("asb.to_device") == 3
    assert names.count("asb.to_host") == 2
    assert names.count("asb.chunk.advance") == -(-STEPS // 4)
    assert names.count("asb.chunk.operands") == 1 + -(-STEPS // 4)

    def contact():
        model.positions = lifted(model, 0.1)
        model.velocities = np.zeros_like(model.positions)
        s.run_steps(4.0 * f, 24, num_iterations=4)

    spans = traced(contact)
    got = parents(spans)
    assert got["asb.contact_tier"] == {"asb.run_steps"}
    assert got["asb.run_steps"] <= {None, "asb.run_steps"}
    assert "asb.contact_tier" in [n for _, _, n in spans]


def test_batched_run_spans_nest_as_listed(small):
    model, s = small
    run = s.make_batched_run()
    B = 3
    P = np.stack([lifted(model, 3.0)] * B)
    F = np.stack([cs.gravity(model)] * B)
    spans = traced(lambda: run(P, np.zeros_like(P), F, 6, num_iterations=4))
    got = parents(spans)
    assert got == {"asb.batched_run": {None},
                   "asb.pack": {"asb.batched_run"},
                   "asb.batched_kernel": {"asb.batched_run"},
                   "asb.unpack": {"asb.batched_run"}}
    names = [n for _, _, n in spans]
    assert names.count("asb.pack") == 3 and names.count("asb.unpack") == 2


def test_counters_hold_the_launch_counters_under_their_names(small):
    """Every launch counter of chip_smoke's list (the twelve wrappers and
    kernel 5's other builds), by ``__name__``, with its value; a call on
    the CPU launches nothing."""
    model, s = small
    fns = cs.port_counters()
    got = profiling.counters()
    assert {fn.__name__: fn.launches for fn in fns} == {
        fn.__name__: got[fn.__name__] for fn in fns}
    assert set(profiling.HOST_COUNTERS + profiling.DEVICE_COUNTERS) <= set(
        got)
    model.positions, model.velocities = lifted(model, 3.0), np.zeros_like(
        model.positions)
    moved = change(lambda: s.run_steps(cs.gravity(model), STEPS,
                                       num_iterations=4))
    assert all(moved[fn.__name__] == 0 for fn in fns)
    assert moved["device.launches"] == 0
    assert moved["steps.tier1"] == STEPS and moved["steps.contact_tier"] == 0


def test_transfer_bytes_are_the_arrays_bytes(small):
    """One run_steps call moves three (N, 3) arrays in the working dtype
    (float32) and two back; a batched call packs three (B, N, 3) float64
    arrays with the permutation and unpacks two with the inverse one."""
    model, s = small
    n = model.n_verts
    model.positions, model.velocities = lifted(model, 3.0), np.zeros_like(
        model.positions)
    moved = change(lambda: s.run_steps(cs.gravity(model), STEPS,
                                       num_iterations=4))
    assert moved["transfer.h2d_bytes"] == 3 * n * 3 * 4
    assert moved["transfer.d2h_bytes"] == 2 * n * 3 * 4
    B = 2
    P = np.stack([lifted(model, 3.0)] * B)
    run = s.make_batched_run()
    moved = change(lambda: run(P, np.zeros_like(P),
                               np.stack([cs.gravity(model)] * B), 5,
                               num_iterations=4))
    assert moved["transfer.h2d_bytes"] == 3 * (B * n * 3 * 8 + n * 8) \
        + 2 * n * 8
    assert moved["transfer.d2h_bytes"] == 2 * B * n * 3 * 8
    assert moved["sim_steps.batched_resident"] == B * 5


def chunk_inputs(s, model, lift, g=1.0, B=None):
    ro = s._resident
    P = s._to_device(lifted(model, lift))
    V = torch.zeros_like(P)
    F = s._to_device(g * cs.gravity(model))
    if B is not None:
        P, V, F = (torch.stack([x] * B).contiguous() for x in (P, V, F))
    return ro, P, V, F


@pytest.mark.parametrize("options", [k5.DEFAULT_OPTIONS,
                                     k5.ChunkOptions(floor_exact=False),
                                     k5.ChunkOptions(floor_bound_skip=False)])
def test_plain_chunk_counts_the_steps_the_bound_sends_on(small, options,
                                                         monkeypatch):
    """A fall onto the floor from 3 units under 4x gravity: the bound trips
    on the steps before the clamp (19 of the first 28 on the small cloth),
    where the exact build checks the y row (every step without the bound),
    and the exact-free build stops at the first trip.
    The count equals the exact row's evaluations as they happen (none in
    the exact-free build); a state far above the floor counts none where
    the bound clears it."""
    model, s = small
    ao = s._affine
    seen = {"trips": 0, "rows": 0}
    real_bound, real_row = k5.floor_bound, k5.AffineContext.y_predictor

    def bound(*a, **kw):
        out = real_bound(*a, **kw)
        seen["trips"] += int(out.sum())
        return out

    def row(self, *a):
        seen["rows"] += 1
        return real_row(self, *a)

    monkeypatch.setattr(k5, "floor_bound", bound)
    monkeypatch.setattr(k5.AffineContext, "y_predictor", row)
    _, P, V, F = chunk_inputs(s, model, 3.0, g=4.0)
    moved = change(lambda: k5.affine_chunked_plain(
        ao, P, V, F, s._rb_extra(), 64, 4, rebase_every=64, options=options))
    assert moved["k5.exact_checks"] == (seen["rows"] if options.floor_exact
                                        else 0)
    if options.floor_bound_skip:
        assert seen["trips"] > 0
    if options == k5.DEFAULT_OPTIONS:
        # the bound tripped on steps the exact row then cleared
        assert seen["rows"] > 1
    _, P, V, F = chunk_inputs(s, model, 50.0)
    seen.update(trips=0, rows=0)
    moved = change(lambda: k5.affine_chunked_plain(
        ao, P, V, F, s._rb_extra(), 16, 4, rebase_every=8, options=options))
    assert seen["trips"] == 0
    assert moved["k5.exact_checks"] == (0 if options.floor_bound_skip
                                        else 16)


def test_plain_batched_chunk_counts_per_sim(small):
    """On (B, 3, N) the counts are per sim: a sim far above the floor adds
    nothing beside one that falls onto it."""
    model, s = small
    ao = s._affine
    _, P, V, F = chunk_inputs(s, model, 3.0, g=4.0)
    one = change(lambda: k5.affine_chunked_plain(
        ao, P, V, F, s._rb_extra(), 64, 4, rebase_every=64))
    far = P.clone()
    far[1] += 50.0
    two = change(lambda: k5.affine_chunked_plain(
        ao, torch.stack([P, far]), torch.stack([V, V]),
        torch.stack([F, F]), s._rb_extra(), 64, 4, rebase_every=64))
    assert one["k5.exact_checks"] > 0
    assert two["k5.exact_checks"] == one["k5.exact_checks"]


def test_plain_kernel3_counts_clamps_and_contact_steps(small):
    """Contact mode: a sim enters at its clamp (the steps whose flags hold
    the clamp bit) and runs in contact mode to the next rebase, so the
    contact-mode steps are the steps from each clamp to the end of its
    rebase window; the lean build clamps and counts none."""
    model, s = small
    ao = s._affine
    _, P, V, F = chunk_inputs(s, model, 0.3, g=4.0)
    every, steps = 8, 32
    got = {}
    moved = change(lambda: got.update(flags=k3.affine_run_plain(
        ao, P, V, F, s._rb_extra(), steps, 4, every, contact_mode=True)[2]))
    clamps = np.flatnonzero(got["flags"].numpy() & 1)
    assert len(clamps) > 0
    assert moved["k3.contact_steps"] == sum(every - i % every
                                            for i in clamps)
    moved = change(lambda: got.update(flags=k3.affine_run_plain(
        ao, P, V, F, s._rb_extra(), steps, 4, every)[2]))
    assert moved["k3.contact_steps"] == 0
    assert int((got["flags"] & 1).sum()) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device counters and the "
                    "kernels with and without them")
    return small_solver(device="cuda", dtype=torch.float32,
                        resident_rebase_every=64)


@pytest.fixture(scope="module")
def card_stretched():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 5's interval bound")
    from test_torch_floor_bound import small_solver as floor_solver

    return floor_solver("stretched", torch.float32, device="cuda")


@pytest.mark.card
def test_device_counters_equal_the_plain_counts(card, card_stretched):
    """Kernel 5's solo chunk and kernel 3's contact-mode call count on the
    card what their plain versions count on the same inputs; kernel 5 also
    on the stretched basis's floor-clear window
    (``tests/test_torch_floor_bound.py``), where its interval bound clears
    steps (``k5.interval_clears``)."""
    from test_torch_floor_bound import CLEAR

    model, s = card
    ao = s._affine
    _, P, V, F = chunk_inputs(s, model, 3.0, g=4.0)
    _, Pc, Vc, Fc = chunk_inputs(s, model, 0.3, g=4.0)
    rb = s._rb_extra()
    model2, s2 = card_stretched
    ao2, rb2, n2 = s2._affine, s2._rb_extra(), CLEAR[2]
    _, P2, V2, F2 = chunk_inputs(s2, model2, CLEAR[0], g=CLEAR[1])
    seen = []
    for name, kernel, plain in (
            ("k5", lambda: k5.affine_chunked(ao, P, V, F, rb, 64, 4,
                                             rebase_every=64),
             lambda: k5.affine_chunked_plain(ao, P, V, F, rb, 64, 4,
                                             rebase_every=64)),
            ("k5", lambda: k5.affine_chunked(ao2, P2, V2, F2, rb2, n2, 4,
                                             rebase_every=n2),
             lambda: k5.affine_chunked_plain(ao2, P2, V2, F2, rb2, n2, 4,
                                             rebase_every=n2)),
            ("k3", lambda: k3.resident_affine_contact(
                ao, Pc, Vc, Fc, rb, 32, 4, rebase_every=8),
             lambda: k3.resident_affine_contact_plain(
                 ao, Pc, Vc, Fc, rb, 32, 4, rebase_every=8))):
        on_card, on_host = change(kernel), change(plain)
        counted = [n for n in profiling.DEVICE_COUNTERS
                   if n.startswith(name)]
        assert {n: on_card[n] for n in counted} == {
            n: on_host[n] for n in counted}, name
        assert any(on_card[n] > 0 for n in counted), name
        assert on_card["device.launches"] > 0 == on_host["device.launches"]
        seen.append(on_card)
    assert seen[1]["k5.interval_clears"] > 0


@pytest.mark.card
def test_kernels_equal_without_the_counters(card, monkeypatch):
    """Kernels 3 and 5 give the same bits with the counters' block and
    with a null pointer."""
    model, s = card
    ao = s._affine
    _, P, V, F = chunk_inputs(s, model, 0.3, g=4.0)
    rb = s._rb_extra()
    calls = (lambda: k5.affine_chunked(ao, P, V, F, rb, 64, 4,
                                       rebase_every=16),
             lambda: k3.resident_affine_contact(ao, P, V, F, rb, 32, 4,
                                                rebase_every=8),
             lambda: k3.resident_affine(ao, P, V, F, rb, 32, 4,
                                        rebase_every=8))
    counted = [fn() for fn in calls]
    for mod in (k5, k3):
        monkeypatch.setattr(mod, "device_counts_ptr", lambda device: None)
    for fn, want in zip(calls, counted):
        got = fn()
        for x, y in zip(got, want):
            if torch.is_tensor(x):
                assert torch.equal(x, y)
            else:
                assert x == y


@pytest.mark.card
def test_run_steps_reads_back_in_its_own_span(card):
    """On the card each chunk's k crosses back inside
    ``asb.chunk.readback``, beside its launch, in ``asb.tier1``; no span is
    mirrored onto the card's timeline (where a reader of the trace would
    count it as device work), while the kernel is there."""
    model, s = card
    model.positions, model.velocities = lifted(model, 3.0), np.zeros_like(
        model.positions)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s.run_steps(cs.gravity(model), 128, num_iterations=4)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = sorted((e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
                   for e in events if e.name().startswith("asb.")
                   and "CUDA" not in str(e.device_type()))
    got = parents(spans)
    assert got["asb.chunk.readback"] == {"asb.tier1"}
    assert got["asb.chunk.launch"] == {"asb.tier1"}
    on_card = {e.name() for e in events if "CUDA" in str(e.device_type())}
    assert not {n for n in on_card if n.startswith("asb.")}
    assert any("ksm::affine_chunk" in n for n in on_card)
