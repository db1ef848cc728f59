"""``chip_smoke.py`` rehearsed on the CPU with the card faked (``torch.cuda``
answers as if a card were there, CUDA events time nothing, ``nvcc``,
``nvidia-smi`` and the profiler are not called), the kernel wrappers on
their plain versions (the tensors lie on the CPU), a 14x14 cloth in place
of the bench scene and a 6x3x3 bar in place of the reference's, short
windows, ensembles of a few sims and at most 8 modes per group.  It checks
the script's own logic (phases, tiered runs, step-by-step holds, bounds,
the two JSON lines), which otherwise runs only on the card; it checks no
kernel.

This file holds the fakes (:func:`rehearsal`, :func:`bench`), which the
rehearsal of each phase imports from its own
``tests/test_torch_chip_smoke_<phase>.py`` (so that ``--dist loadfile``
spreads the phases over the workers), and one run of ``main()`` end to
end at the smallest sizes (:data:`SMALLEST`): the phases in their order
and the two JSON lines."""

import json
import types

import pytest
import torch

import chip_smoke as cs
from animsnapbases_tpu_torch import device, holds
from animsnapbases_tpu_torch.ops import _build, affine, affine_chunked, cluster
from animsnapbases_tpu_torch.sim import reduced


@pytest.fixture(autouse=True)
def one_thread():
    """The rehearsal on one torch thread: its tensors are small, and the
    CPU's threads, spinning beside other test workers, only slow it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
                       rebase_every, variant):
    """csrc/affine.cu's launch for one sim on the plain version: the flags
    the plain loop records of each step (steps done, contact mode), the
    coefficients over the last anchors and, in contact mode, the y
    state."""
    done = num_steps
    if variant == "exit":
        P_out, V_out, done = affine.resident_affine_exit_plain(
            ao, P, V, fext, rb_extra, num_steps, num_iterations, rebase_every)
    ctx, st, steps = affine.affine_run_plain(
        ao, P, V, fext, rb_extra, done, num_iterations, rebase_every,
        contact_mode=variant == "contact")
    if variant != "exit":
        P_out, V_out = ctx.output(st)
    flags = torch.zeros(affine.FLAG_SLOTS + max(num_steps, 1),
                        dtype=torch.int32)
    flags[2] = done
    flags[affine.FLAG_SLOTS:affine.FLAG_SLOTS + done] = steps
    coef = torch.cat([x.flatten() for x in (st.ap, st.av, st.wp, st.wv)])
    y = None
    if st.mode is not None:
        flags[affine.MODE_SLOT] = int(st.mode)
        y = (st.Py, st.Vy, st.buPy, st.buVy)
    return P_out, V_out, flags, coef, y


def _sim(rb, b):
    """Sim b's target-term schedule of a batch's (shared or per sim)."""
    return rb[b] if rb.dim() == 4 else rb


def _launch_plain(ao, P, V, fext, rb_extra, *args):
    """The same for one sim (3, N) or, sim by sim, for a batch."""
    if P.dim() == 2:
        return _solo_launch_plain(ao, P, V, fext, rb_extra, *args)
    outs = [_solo_launch_plain(ao, P[b], V[b], fext[b], _sim(rb_extra, b),
                               *args)
            for b in range(P.shape[0])]
    *state, ys = zip(*outs)
    return (*(torch.stack(x) for x in state),
            None if ys[0] is None else tuple(torch.stack(t)
                                             for t in zip(*ys)))


def _chunk_launch_plain(ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1,
                        bu_fa, rb_ex, steps, num_iterations, floor_h,
                        options=affine_chunked.DEFAULT_OPTIONS):
    """The chunk launch (csrc/affine_chunked.cuh) of the build of
    ``options`` on the plain chunk, sim by sim -> (coefficients, k per
    sim)."""
    if P.dim() == 2:
        *coefs, k = affine_chunked.affine_chunk_plain(
            ao, P, V, fa, ymm, first, b0s, b1s, fas, bu0, bu1, bu_fa, rb_ex,
            steps, num_iterations, floor_h, options)
        return (torch.cat([x.flatten() for x in coefs]),
                torch.tensor(k, dtype=torch.int32))

    def sim(x, b):
        return None if x is None else x[b]

    outs = [_chunk_launch_plain(
        ao, P[b], V[b], fa[b], ymm[b], first, sim(b0s, b), sim(b1s, b),
        sim(fas, b), bu0[b], bu1[b], bu_fa[b], _sim(rb_ex, b), steps,
        num_iterations, floor_h, options)
        for b in range(P.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def _fake_run(cmd, *a, **k):
    """``subprocess.run`` of the rehearsal: the sweep runs (its workers on
    the CPU); nvidia-smi and nvcc answer a line."""
    import subprocess

    if "animsnapbases_tpu_torch.sweep" in cmd:
        return subprocess.run(cmd, *a, **k)
    return types.SimpleNamespace(returncode=0, stderr="",
                                 stdout="cpu, 0 W\n")


class _FakePopen:
    """``subprocess.Popen`` of the rehearsal: the battery, started in the
    background, writes its nine PASS lines (its checks are rehearsed in
    tests/test_torch_smoke.py) and has ended."""

    def __init__(self, cmd, stdout=None, stderr=None, **k):
        from animsnapbases_tpu_torch import smoke

        assert "animsnapbases_tpu_torch.smoke" in cmd
        stdout.write("".join(f"PASS {name} (0.0s)\n"
                             for name in smoke.CHECKS).encode())

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0


def _fake_card(monkeypatch):
    """The card faked as the module docstring says, the scene cut to
    size; returns the script's own ``require``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
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
        run=_fake_run, Popen=_FakePopen))
    monkeypatch.setattr(cs, "device_breakdown",
                        lambda torch_, fn: (fn(), 1.0, {"kernel": 0.5})[1:])
    monkeypatch.setattr(cs, "device_ms", lambda torch_, fn, reps=1:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(cluster, "resident_clusters", lambda lib, plan: 40)
    timed = cs.cuda_ms
    monkeypatch.setattr(cs, "cuda_ms", lambda torch_, fn, reps=1, warmup=0:
                        timed(torch_, fn, reps=1, warmup=0))
    monkeypatch.setattr(cs, "SCENE_STEPS", 8)
    monkeypatch.setattr(cs, "WINDOW_STEPS", 16)
    monkeypatch.setattr(cs, "PLAIN_REPS", 1)
    for name, value in (("ENSEMBLE", 4), ("ENSEMBLE_SIZES", (1, 2, 4)),
                        ("MIXED", 4), ("SIM_ROWS", 2), ("MIXED_EVERY", 2),
                        ("CONTACT_RISE", 0.0), ("CRUMPLE", 3),
                        ("CONTACT_EVERY", (256, 3, 6)), ("DRIFT_STEPS", 12),
                        ("WITNESS_DRAWS", 4), ("BAR_SIZE", (6, 3, 3)),
                        ("NEW_DEPTH", 4), ("BAR_DEPTH", 4), ("NEW_BATCH", 4),
                        ("POKE_CYCLES", 1), ("POKE_WINDOW", 16),
                        ("POKE_TAIL", 4), ("POKE_ROWS", 6),
                        ("POKE_SHARED", 4), ("POKE_DEPTH", 4),
                        ("POKE_ROUNDS", 1), ("OPTION_ROUNDS", 1),
                        ("MEGA_ROWS", 12), ("MEGA_R", 8), ("MEGA_REST", 24),
                        ("MEGA_NEAR", 12), ("MEGA_BATCH", 2),
                        ("MEGA_BATCH_STEPS", 8), ("MEGA_DEPTH", 3),
                        ("MEGA_ROUNDS", 1), ("FOM_FRAMES", 12),
                        ("CONSTR_MODES", 6), ("POS_MODES", 10),
                        ("REDUCED_MODES", 6), ("POSB_FRAMES", 16),
                        ("POSB_SERVE", 6),
                        ("POSB_OVERRIDES", {"vertPos_numFrames": 8,
                                            "vertPos_numComponents": 6,
                                            "splocs_max_itrs": 2,
                                            "splocs_admm_num_itrs": 3})):
        monkeypatch.setattr(cs, name, value)
    mega = cs.megacloth_solver

    def small_mega(torch_, dev):
        # the large-model route at the rehearsal's 144 vertices
        model, solver = mega(torch_, dev)
        solver.CHUNKED_TIER1_MIN_VERTS = 0
        solver.prepare(solver.args)
        return model, solver

    monkeypatch.setattr(cs, "megacloth_solver", small_mega)
    bench = cs.bench_scene
    monkeypatch.setattr(cs, "bench_scene", lambda cls, cloth: bench(
        cls, lambda rows, cols: cloth(14, 14)))
    solver = cs.scene_solver
    def small_solver(syn, model, K, r, damping, components=None, **kw):
        if components is not None:
            kw["components"] = {k: min(v, 8) for k, v in components.items()}
        return solver(syn, model, min(K, 12), min(r, 16), damping, **kw)

    monkeypatch.setattr(cs, "scene_solver", small_solver)
    return cs.require


KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
PLAN_KEYS = {"staged", "from_l2", "smem_bytes", "bits", "cluster",
             "threads"}
SOLO = ["fused_reduced_iterations", "resident_multistep", "resident_affine",
        "resident_affine_exit", "affine_chunked", "resident_affine_contact"]
BATCHED = ["fused_reduced_iterations_batched", "resident_multistep_batched",
           "resident_affine_batched", "affine_chunked_batched",
           "resident_affine_contact_batched", "resident_affine_exit_batched"]
# the kernels the entry points serve: all but kernel 4's batched build,
# which chip_smoke.exit_batched launches directly
SERVED = SOLO + [k for k in BATCHED if k != "resident_affine_exit_batched"]
BUILDS = [f"affine_chunked{b}[{label}]"
          for label in ("floor_exact=False", "floor_bound_skip=False",
                        "fold_vc=False", "sqrt_free_bound=False",
                        "static_rb=False") for b in ("", "_batched")]


def lenient(monkeypatch, held):
    """The script's ``require`` but for the holds the rehearsal cannot
    meet: the plain versions count no launches, a batched plain version
    differs from the solo one in the order of its sums, and phase [9]'s
    fits do not converge in the rehearsal's few Adam steps."""
    def require(ok, what):
        if ("never launched" not in what
                and "differs from the solo kernel" not in what
                and "did not converge" not in what):
            held(ok, what)

    monkeypatch.setattr(cs, "require", require)


def rehearsal(monkeypatch):
    """The card faked (:func:`_fake_card`), the holds :func:`lenient` ->
    (the launch counters, the device)."""
    lenient(monkeypatch, _fake_card(monkeypatch))
    return cs.port_counters(), torch.device("cpu")


def bench(monkeypatch):
    """:func:`rehearsal`, then the bench scene's main path
    (``chip_smoke.bench_phase``) -> (counters, its state)."""
    counted, dev = rehearsal(monkeypatch)
    return counted, cs.bench_phase(torch, counted, dev)


def assert_entries(entries, names):
    """Kernels-line entries of ``names``, in order, with the contract's
    keys and a positive bound."""
    assert [k["name"] for k in entries] == names
    for k in entries:
        assert KEYS <= set(k), k["name"]
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes",
                                                        "operations")


# main() end to end at its smallest: 4 iterations a step, one of kernel 5's
# other builds, one tet/bending scene (the bending cloth), phase [7]'s
# recordings of 12 frames and example configs of 5 frames and 4 components,
# phase [8]'s cloth at 12x12, phase [9]'s rollouts of 4 steps and fits of 2
# Adam steps, phase [10] at the fakes' sizes (16 frames, 8 of them
# imported, 6 components, 2 SPLOCS iterations), phase [11]'s event demo
# on a 6x6 cloth for 22 frames (its first event crossed) with example
# configs of 5 frames and 4 components and r = 6, phase [12]'s POD at
# 2,001 rows
SMALLEST = {"ITERATIONS": 4, "OPTION_BUILDS": cs.OPTION_BUILDS[:1],
            "GROUP_FRAMES": 12, "BAR_FRAMES": 12, "GROUP_STEPS": 6,
            "GROUP_OVERRIDES": {"numFrames": 5, "desired_num_components": 4},
            "SC_ROWS": 12, "SC_R": 8, "SC_WINDOW": 48, "SC_FOLD_STEPS": 8,
            "SC_DEPTH": 3, "SC_SHORT": 8, "SC_REPS": 1, "DIFF_FIT_STEPS": 2,
            "DIFF_HORIZON": 4, "DIFF_REPS": 1,
            "SCEN_SYSTEM": {"cloth_width": 6, "cloth_height": 6},
            "SCEN_FRAMES": 22, "SCEN_POS_MODES": 6,
            "SCEN_OVERRIDES": {"numFrames": 5, "desired_num_components": 4},
            "MC_POD": (2_001, 16)}
SMALLEST_SCENES = ("bending cloth",)


def test_chip_smoke_phases_run_on_the_plain_versions(monkeypatch, capsys):
    rehearsal(monkeypatch)
    for name, value in SMALLEST.items():
        monkeypatch.setattr(cs, name, value)
    scenes = cs.tet_bending_scenes
    monkeypatch.setattr(cs, "tet_bending_scenes", lambda: [
        s for s in scenes() if s[0] in SMALLEST_SCENES])
    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 0}}
    kernels = json.loads(lines[-2])["kernels"]
    assert_entries(kernels[:12], SOLO + BATCHED)
    assert [k["name"] for k in kernels[12:]] == BUILDS[:2]
    for k in kernels[12:]:
        assert KEYS <= set(k)
    for k in kernels[:12]:
        assert {"scenes", "animated"} <= set(k), k["name"]
    assert sorted(kernels[0]["scenes"]) == list(SMALLEST_SCENES)
    k1, k5 = kernels[0], kernels[4]
    assert {"real_bases", "per_group", "self_collision",
            "position_bases", "scenarios"} <= set(k1)
    assert {"real_bases", "per_group", "megacloth", "self_collision",
            "position_bases"} <= set(k5)
    for name in cs.MC_KERNELS:
        assert "multichip" in next(k for k in kernels if k["name"] == name)
    out = "\n".join(lines)
    order = ["[1] built", "[2] step + run_steps", "[2] tiered runs",
             "[3] bench scene holds", "[4] bench scene times",
             "[2-4] ensemble serving", "[2-4] kernel 5's other builds",
             "[2-4] tet, bending and block-form scenes",
             "[2-4] scale: the megacloth", "[6] pipeline: record, bases",
             "[7] per-group workflow:", "[8] self-collision:",
             "[9] differentiable rollouts:", "[10] position bases: record",
             "[11] scenarios, command lines and analysis",
             "[12] sharded paths, battery, sweep and native I/O"]
    at = [out.index(line) for line in order]
    assert at == sorted(at)


def test_chip_smoke_branch_step_rules_run(monkeypatch, capsys):
    """Contact mode's rules of ``carried_steps`` (each step against the
    plain step given the kernel's u, the y state included; the branch
    steps' distances from the float64 step over the window, with the
    float64 witness from inputs one float32 unit away) on the contact
    scene, every step made a branch step (STEP_TOL < 0) and the window's
    limit made tighter than equal (ACC_RATIO < 1), so that each rule is
    computed and fails; its verdicts are collected, not held."""
    _fake_card(monkeypatch)
    verdicts = []
    # the rules live in animsnapbases_tpu_torch/holds.py, which chip_smoke
    # imports
    monkeypatch.setattr(holds, "require", lambda ok, what: verdicts.append(
        (ok, what)))
    monkeypatch.setattr(holds, "STEP_TOL", -1.0)
    monkeypatch.setattr(holds, "ACC_RATIO", 0.5)
    from animsnapbases_tpu_torch.ops.affine import (
        resident_affine_contact_plain)
    from animsnapbases_tpu_torch.sim.model import DeformableModel
    from animsnapbases_tpu_torch.geometry.procedural import cloth_model
    from animsnapbases_tpu_torch.utils.synthetic import (
        synthetic_reduced_solver)

    model = cs.bench_scene(DeformableModel, cloth_model)
    solver = cs.scene_solver(synthetic_reduced_solver, model, K=40, r=64,
                             damping=2e-3, device="cpu", dtype=torch.float32,
                             matmul_dtype=torch.bfloat16)
    ao = solver._affine
    P, V = (solver._to_device(x) for x in cs.contact_state(model))
    F = solver._to_device(cs.gravity(model))
    rb = solver._rb_extra()
    _, flags = cs.carried_steps(
        torch, "rehearsal", "3c", ao,
        lambda *a: resident_affine_contact_plain(*a, rebase_every=3), P, V,
        F, rb, 6, 3)
    out = capsys.readouterr().out
    assert "witness" in out and "over the branch steps" in out
    assert "given the kernel's u, the y state included" in out
    failed = [what for ok, what in verdicts if not ok]
    assert any("given the kernel's u buPy" in what for what in failed)
    assert any("branch steps the kernel lies" in what for what in failed)
    assert flags.shape[-1] == affine.FLAG_SLOTS + 6


def test_megacloth_scene_is_the_bench_script_model():
    """``chip_smoke.megacloth_scene(rows)`` builds the model of
    scripts/bench_megacloth.py:60-70 (the JAX package's lines, at 12 rows
    here): the same positions, pinned vertices, masses and constraint
    groups with the same data."""
    import numpy as np

    from animsnapbases_tpu.geometry.procedural import cloth_model
    from animsnapbases_tpu.sim.model import DeformableModel

    rows = 12
    V, F = cloth_model(rows, rows)
    V = V.copy()
    V[:, 2] += 0.1 * V[:, 0]
    ref = DeformableModel(V, F, masses=np.full(len(V), 10.0),
                          floor_collision=True, init_height_shift=10.0)
    ref.add_tri_constrain_strain(0.95, 1.05, wi=1e4)
    ref.add_edge_spring_constraint(wi=1e4)
    ref.compute_cloth_corner_indices()
    ref.fix_surface_side_vertices("left")

    model = cs.megacloth_scene(rows)
    assert model.n_verts == rows * rows
    np.testing.assert_array_equal(model.positions, ref.positions)
    np.testing.assert_array_equal(model.faces, ref.faces)
    np.testing.assert_array_equal(model.mass, ref.mass)
    np.testing.assert_array_equal(np.where(model.fixed_flags)[0],
                                  np.where(np.asarray(ref.fixed_flags))[0])
    assert 0 < model.fixed_flags.sum() < rows * rows
    assert model.floor_collision and model.floor_height == ref.floor_height
    assert sorted(model.groups) == sorted(ref.groups)
    for name, g in model.groups.items():
        want = ref.groups[name].data
        assert sorted(g.data) == sorted(want), name
        for key, value in g.data.items():
            np.testing.assert_allclose(np.asarray(value, dtype=float),
                                       np.asarray(want[key], dtype=float),
                                       rtol=1e-12, atol=0, err_msg=key)
