"""``chip_smoke.py`` rehearsed on the CPU: its phases run end to end with the
card faked (``torch.cuda`` answers as if a card were there, CUDA events
time nothing, ``nvcc``, ``nvidia-smi`` and the profiler are not called),
the kernel wrappers on their plain versions (the tensors lie on the CPU),
a 14x14 cloth in place of the bench scene, short windows and ensembles of
a few sims.  It checks the script's own logic (phases, tiered runs,
step-by-step holds, bounds, the two JSON lines), which otherwise runs only
on the card; it checks no kernel."""

import json
import types

import torch

import chip_smoke as cs
from animsnapbases_tpu_torch import device
from animsnapbases_tpu_torch.ops import _build, affine, affine_chunked
from animsnapbases_tpu_torch.sim import reduced


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _solo_launch_plain(ao, P, V, fext, rb_extra, num_steps, num_iterations,
                       rebase_every, exit_variant):
    """csrc/affine.cu's launch for one sim on the plain version, with the
    flags of its steps (whether each clamped, from one-step calls; every
    step done) and the coefficients of a contact-free call without a
    rebase."""
    P_out, V_out = affine.resident_affine_plain(
        ao, P, V, fext, rb_extra, num_steps, num_iterations, rebase_every)
    flags = torch.zeros(affine.FLAG_SLOTS + max(num_steps, 1),
                        dtype=torch.int32)
    flags[2] = num_steps
    fa = affine.force_term(ao.res, fext)
    Pi, Vi = P, V
    for i in range(num_steps):
        ctx = affine.AffineContext(ao, fa)
        st = ctx.init_anchors(Pi, Vi)
        asn, wsn = ctx.predictor(st)[5:]
        flags[affine.FLAG_SLOTS + i] = int(bool(
            (ctx.y_predictor(st, asn, wsn) < ao.floor_level).any()))
        Pi, Vi = affine.resident_affine_plain(ao, Pi, Vi, fext, rb_extra, 1,
                                              num_iterations)
    ctx = affine.AffineContext(ao, fa)
    st = ctx.init_anchors(P, V)
    for _ in range(num_steps):
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        ctx.free_step(st, asn, wsn, avd, wp, rb_extra, num_iterations)
    coef = torch.cat([x.flatten() for x in (st.ap, st.av, st.wp, st.wv)])
    return P_out, V_out, flags, coef


def _launch_plain(ao, P, V, fext, *args):
    """The same for one sim (3, N) or, sim by sim, for a batch."""
    if P.dim() == 2:
        return _solo_launch_plain(ao, P, V, fext, *args)
    outs = [_solo_launch_plain(ao, P[b], V[b], fext[b], *args)
            for b in range(P.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def _chunk_launch_plain(ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1,
                        bu_fa, rb_ex, steps, num_iterations, floor_h):
    """csrc/affine_chunked.cu's launch on the plain chunk, sim by sim ->
    (coefficients, k per sim)."""
    if P.dim() == 2:
        *coefs, k = affine_chunked.affine_chunk_plain(
            ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex,
            steps, num_iterations, floor_h)
        return (torch.cat([x.flatten() for x in coefs]),
                torch.tensor(k, dtype=torch.int32))
    outs = [_chunk_launch_plain(
        ao, P[b], V[b], fa[b], ymm[b], first, b0s[b], b1s[b], fas[b], bu0[b],
        bu1[b], bu_fa[b], rb_ex, steps, num_iterations, floor_h)
        for b in range(P.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def test_chip_smoke_phases_run_on_the_plain_versions(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    # every "cuda" device the script asks for is the CPU, in the solver
    # module too (it binds the name when it is imported)
    for module in (device, reduced):
        monkeypatch.setattr(module, "resolve_device",
                            lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(_build, "build", lambda names=None: {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(affine, "_launch_affine", _launch_plain)
    monkeypatch.setattr(affine_chunked, "_chunk_cuda",
                        affine_chunked.affine_chunk_plain)
    monkeypatch.setattr(affine_chunked, "_chunk_launch", _chunk_launch_plain)
    monkeypatch.setattr(cs, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout="cpu, 0 W\n")))
    monkeypatch.setattr(cs, "device_breakdown",
                        lambda torch_, fn: (fn(), 1.0, {"kernel": 0.5})[1:])
    timed = cs.cuda_ms
    monkeypatch.setattr(cs, "cuda_ms", lambda torch_, fn, reps=1, warmup=0:
                        timed(torch_, fn, reps=1, warmup=0))
    monkeypatch.setattr(cs, "SCENE_STEPS", 8)
    monkeypatch.setattr(cs, "WINDOW_STEPS", 16)
    monkeypatch.setattr(cs, "PLAIN_REPS", 1)
    for name, value in (("ENSEMBLE", 4), ("ENSEMBLE_SIZES", (1, 2, 4)),
                        ("MIXED", 4), ("SIM_ROWS", 2), ("MIXED_EVERY", 2),
                        ("CONTACT_RISE", 0.0)):
        monkeypatch.setattr(cs, name, value)
    bench = cs.bench_scene
    monkeypatch.setattr(cs, "bench_scene", lambda cls, cloth: bench(
        cls, lambda rows, cols: cloth(14, 14)))
    solver = cs.scene_solver
    monkeypatch.setattr(cs, "scene_solver",
                        lambda syn, model, K, r, damping, **kw: solver(
                            syn, model, min(K, 12), min(r, 16), damping,
                            **kw))
    held = cs.require

    def require(ok, what):
        # the plain versions count no launches, and a batched plain version
        # differs from the solo one in the order of its sums
        if ("never launched" not in what
                and "differs from the solo kernel" not in what):
            held(ok, what)

    monkeypatch.setattr(cs, "require", require)
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 0}}
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [
        "fused_reduced_iterations", "resident_multistep", "resident_affine",
        "resident_affine_exit", "affine_chunked",
        "fused_reduced_iterations_batched", "resident_multistep_batched",
        "resident_affine_batched", "affine_chunked_batched"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k)
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
