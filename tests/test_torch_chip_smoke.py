"""``chip_smoke.py`` rehearsed on the CPU: its phases run end to end with the
card faked (``torch.cuda`` answers as if a card were there, CUDA events
time nothing, ``nvcc`` and ``nvidia-smi`` are not called), the kernel
wrappers on their plain versions (the tensors lie on the CPU), a 14x14
cloth in place of the bench scene and short windows.  It checks the
script's own logic (phases, tiered runs, step-by-step holds, bounds, the
two JSON lines), which otherwise runs only on the card; it checks no
kernel."""

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


def _launch_plain(ao, P, V, fext, rb_extra, num_steps, num_iterations,
                  rebase_every, exit_variant):
    """csrc/affine.cu's launch on the plain version, with the flags a
    one-step call leaves (whether its step clamped; every step done) and
    the coefficients of a contact-free call without a rebase."""
    P_out, V_out = affine.resident_affine_plain(
        ao, P, V, fext, rb_extra, num_steps, num_iterations, rebase_every)
    flags = torch.zeros(affine.FLAG_SLOTS + num_steps, dtype=torch.int32)
    flags[2] = num_steps
    ctx = affine.AffineContext(ao, affine.force_term(ao.res, fext))
    st = ctx.init_anchors(P, V)
    asn, wsn = ctx.predictor(st)[5:]
    flags[affine.FLAG_SLOTS] = int(bool(
        (ctx.y_predictor(st, asn, wsn) < ao.floor_level).any()))
    for _ in range(num_steps):
        _, _, wp, _, avd, asn, wsn = ctx.predictor(st)
        ctx.free_step(st, asn, wsn, avd, wp, rb_extra, num_iterations)
    coef = torch.cat([x.flatten() for x in (st.ap, st.av, st.wp, st.wv)])
    return P_out, V_out, flags, coef


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
    monkeypatch.setattr(cs, "subprocess", types.SimpleNamespace(
        run=lambda *a, **k: types.SimpleNamespace(stdout="cpu, 0 W\n")))
    timed = cs.cuda_ms
    monkeypatch.setattr(cs, "cuda_ms", lambda torch_, fn, reps=1, warmup=0:
                        timed(torch_, fn, reps=1, warmup=0))
    monkeypatch.setattr(cs, "SCENE_STEPS", 8)
    monkeypatch.setattr(cs, "WINDOW_STEPS", 16)
    monkeypatch.setattr(cs, "PLAIN_REPS", 1)
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
        # the plain versions count no launches
        if "never launched" not in what:
            held(ok, what)

    monkeypatch.setattr(cs, "require", require)
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 0}}
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == [
        "fused_reduced_iterations", "resident_multistep", "resident_affine",
        "resident_affine_exit", "affine_chunked"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k)
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
