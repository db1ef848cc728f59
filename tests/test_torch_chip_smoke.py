"""``chip_smoke.py`` rehearsed on the CPU: its phases run end to end with the
card faked (``torch.cuda`` answers as if a card were there, CUDA events
time nothing, ``nvcc``, ``nvidia-smi`` and the profiler are not called),
the kernel wrappers on their plain versions (the tensors lie on the CPU),
a 14x14 cloth in place of the bench scene and a 6x3x3 bar in place of the
reference's, short windows, ensembles of a few sims and at most 8 modes
per group.  It checks the script's own logic (phases, tiered runs,
step-by-step holds, bounds, the two JSON lines), which otherwise runs only
on the card; it checks no kernel."""

import json
import types

import torch

import chip_smoke as cs
from animsnapbases_tpu_torch import device
from animsnapbases_tpu_torch.ops import _build, affine, affine_chunked, cluster
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


def _fake_card(monkeypatch):
    """The card faked as the module docstring says, the scene cut to
    size; returns the script's own ``require``."""
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
                        ("NEW_DEPTH", 4), ("NEW_BATCH", 4),
                        ("POKE_CYCLES", 1), ("POKE_WINDOW", 16),
                        ("POKE_TAIL", 4), ("POKE_ROWS", 6),
                        ("POKE_SHARED", 4), ("POKE_DEPTH", 4),
                        ("POKE_ROUNDS", 1), ("OPTION_ROUNDS", 1),
                        ("MEGA_ROWS", 12), ("MEGA_R", 8), ("MEGA_REST", 24),
                        ("MEGA_NEAR", 12), ("MEGA_BATCH", 2),
                        ("MEGA_BATCH_STEPS", 8), ("MEGA_DEPTH", 3),
                        ("MEGA_ROUNDS", 1), ("FOM_FRAMES", 12),
                        ("CONSTR_MODES", 6), ("POS_MODES", 10),
                        ("REDUCED_MODES", 6)):
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


def test_chip_smoke_phases_run_on_the_plain_versions(monkeypatch, capsys):
    held = _fake_card(monkeypatch)

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
    builds = [f"affine_chunked{b}[{label}]"
              for label in ("floor_exact=False", "floor_bound_skip=False",
                            "fold_vc=False", "sqrt_free_bound=False",
                            "static_rb=False") for b in ("", "_batched")]
    assert [k["name"] for k in kernels] == [
        "fused_reduced_iterations", "resident_multistep", "resident_affine",
        "resident_affine_exit", "affine_chunked", "resident_affine_contact",
        "fused_reduced_iterations_batched", "resident_multistep_batched",
        "resident_affine_batched", "affine_chunked_batched",
        "resident_affine_contact_batched", *builds]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k)
        assert k["bound_ms"] > 0 and k["bound_by"] in ("bytes", "operations")
    # kernels 1 and 5 on the cluster loop: the staging plans of their
    # widths (bench, per scene, megacloth), kernel 1's device time and the
    # loop's slope and intercept; the operations' floor on the cluster's
    # SMs is computed, not measured, and stays out of the kernels line
    plan_keys = {"staged", "from_l2", "smem_bytes", "bits", "cluster",
                 "threads"}
    k1, k5 = kernels[0], kernels[4]
    assert plan_keys | {"resident_clusters"} <= set(k1["staging_plan"])
    assert plan_keys | {"resident_clusters"} <= set(k5["staging_plan"])
    assert plan_keys <= set(k5["megacloth_staging_plan"])
    assert k1["staging_plan"]["staged"] and k5["staging_plan"]["staged"]
    for k in (k1, k5):
        assert k["staging_plan"]["cluster"] == [3, 1, 1]
        assert 0 < k["staging_plan"]["smem_bytes"] <= cluster.SMEM_MAX
        for entry in k["scenes"].values():
            assert plan_keys <= set(entry["staging_plan"])
    assert {"device_ms", "device_us_per_iteration",
            "device_intercept_us"} <= set(k1)
    # the pipeline phase: kernels 1 and 5 on real bases (record -> bases
    # -> prepare -> run_steps + step), each with its plan at the recorded
    # r, its error against the plain version, its times and bound
    for k in (k1, k5):
        real = k["real_bases"]
        assert {"launches", "launches_path", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "staging_plan", "vs_fom",
                "record_vs_cpu", "pipeline_s"} <= set(real)
        assert plan_keys <= set(real["staging_plan"])
        assert real["bound_ms"] > 0 and real["record_vs_cpu"] <= 1e-6
        assert set(real["vs_fom"]) == {"mean", "p99", "max"}
    assert k5["real_bases"]["entry_steps_per_s"] > 0
    assert "step_ms" in k1["real_bases"]
    assert all(k["name"] in ("fused_reduced_iterations", "affine_chunked")
               for k in kernels if "real_bases" in k)
    assert "device_ms" in kernels[6]
    # kernels 2-4 on the cluster loop too: their plans at the bench widths,
    # and the batched builds' plan at each batch size with the clusters the
    # card holds at once and the waves the sims take
    for k in (*kernels[1:4], kernels[5]):
        assert plan_keys | {"resident_clusters"} <= set(k["staging_plan"])
    for k in (kernels[7], kernels[8], kernels[10]):
        by_sims = k["staging_plan_by_sims"]
        assert set(by_sims) == {str(B) for B in cs.ENSEMBLE_SIZES}
        assert all(v["waves"] >= 1 for v in by_sims.values())
    assert {"us_per_iteration", "intercept_us_per_step",
            "window_us_per_iteration",
            "window_intercept_us_per_step"} <= set(k5)
    for k in kernels:
        assert not any(key.startswith("cluster_floor") for key in k)
    out = "\n".join(lines)
    for line in ("[6] pipeline: recorded 12 frames", "equals the first bit "
                 "for bit (trajectory and p-snapshots): True",
                 "the card's recording against the CPU's",
                 "[6] pipeline, tris_strain: the card's bases against the "
                 "CPU's", "reduced-vs-FOM after 12 steps",
                 "[6] pipeline on real bases: run_steps over 16 steps "
                 "(certified)", "pipeline, kernel 5 (ring-down state), "
                 "carried steps"):
        assert line in out, line
    assert "on the cluster's 3 SMs" in out
    assert "kernel 1: staging plan" in out and "kernel 5: staging plan" in out
    assert "kernel 2: staging plan" in out
    assert "kernels 3 and 4: staging plan" in out
    assert "clusters resident at once" in out
    # kernel 5's builds: each on its own path (no launches counted here: the
    # plain versions run), timed beside the default
    # build; the scale phase's megacloth numbers on kernel 5 (both builds),
    # batched kernel 5's exact-free build and kernel 2
    for k in kernels[11:]:
        assert k["launches"] >= 0 and k["default_ms"] > 0, k["name"]
    assert kernels[11]["source"].endswith("affine_chunked_free.cu")
    assert kernels[13]["source"].endswith("affine_chunked_opts.cu")
    for i in (1, 4, 11, 12):
        assert kernels[i]["megacloth"], kernels[i]["name"]
    assert kernels[11]["megacloth"]["near_floor_tier1_calls"][0] > 0
    assert kernels[4]["exact_check_us_bound_off"] is not None
    kernels = kernels[:11]
    assert kernels[5]["recursion_drift"]
    assert kernels[10]["launches_path"].startswith(
        "make_batched_run, B=4 ring-down, default")
    # the tet, bending and block-form scenes: every kernel timed and
    # bounded on the scenes that drive it, kernels 1, 5 and 3' (solo and
    # batched) on all five
    scenes = [label for label, *_ in cs.tet_bending_scenes()]
    for k in kernels:
        assert k["scenes"], k["name"]
        for entry in k["scenes"].values():
            assert keys - {"name", "route", "source", "replaces",
                           "library_ms"} <= set(entry)
            assert entry["bound_ms"] > 0
    for i in (0, 4, 5, 6, 10):
        assert sorted(kernels[i]["scenes"]) == sorted(scenes)
    # animated targets: every kernel with a schedule timed with it and
    # with a static term, each beside its bound; kernel 1 on the recorded
    # run
    for k in kernels:
        anim = k["animated"]
        if k["name"] == "fused_reduced_iterations_batched":
            continue
        assert anim["launches"] >= 0, k["name"]
        if k["name"] != "fused_reduced_iterations":
            assert {"ms", "static_ms", "bound_ms", "static_bound_ms",
                    "max_abs_err"} <= set(anim), k["name"]
            assert anim["bound_ms"] > anim["static_bound_ms"] > 0
    assert kernels[0]["scenes"]["bar, block form"]["table_columns"] == {
        "tets_deformation_gradient": 3 * kernels[0]["scenes"][
            "bar, row form"]["table_columns"]["tets_deformation_gradient"]}


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
    monkeypatch.setattr(cs, "require", lambda ok, what: verdicts.append(
        (ok, what)))
    monkeypatch.setattr(cs, "STEP_TOL", -1.0)
    monkeypatch.setattr(cs, "ACC_RATIO", 0.5)
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
