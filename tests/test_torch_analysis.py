"""The port's analysis (``animsnapbases_tpu_torch/analysis``) against the
JAX package's on the CPU: the on-mesh accuracy measures, the npy
comparison tool and the accuracy report's gates to 1e-12, the PCA and
constraint-basis diagnostics (the same numbers and CSVs), and the PNGs the
figures and the viewers write (matplotlib is installed here; the port
imports it only where it draws)."""

import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from animsnapbases_tpu.analysis import accuracy as jacc
from animsnapbases_tpu.analysis import compare as jcmp
from animsnapbases_tpu_torch.analysis import accuracy as acc
from animsnapbases_tpu_torch.analysis import accuracy_report as report
from animsnapbases_tpu_torch.analysis import compare as cmp
from animsnapbases_tpu_torch.geometry.procedural import cloth_model
from test_torch_scenarios import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def sequences(F=5, rows=6, seed=0):
    """A cloth's (F, N, 3) full sequence, a perturbed 'reduced' one and
    the faces."""
    V, faces = cloth_model(rows, rows)
    rng = np.random.default_rng(seed)
    full = V[None] + 0.05 * rng.normal(size=(F,) + V.shape)
    red = full + 1e-3 * rng.normal(size=full.shape)
    return full, red, faces


def assert_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["frame"] == y["frame"]
        for k in ("rel_l2", "normal_angle"):
            assert abs(x[k] - y[k]) <= TOL * max(abs(y[k]), 1e-300), k


def test_accuracy_measures_match_jax(tmp_path):
    """``per_vertex_relative_l2``, ``normal_angle_error`` and
    ``compute_accuracy_arrays`` on arrays and on tensors, and
    ``compute_accuracy`` on ``.off`` sequences with its CSV."""
    from animsnapbases_tpu_torch.io.meshes import save_off

    full, red, faces = sequences()
    for f in range(len(full)):
        for args in ((full[f], red[f]), (torch.as_tensor(full[f]),
                                         torch.as_tensor(red[f]))):
            m, v = acc.per_vertex_relative_l2(*args)
            jm, jv = jacc.per_vertex_relative_l2(full[f], red[f])
            np.testing.assert_allclose(m, jm, rtol=TOL, atol=0)
            assert abs(v - jv) <= TOL * jv
            m, v = acc.normal_angle_error(*args, faces)
            jm, jv = jacc.normal_angle_error(full[f], red[f], faces)
            np.testing.assert_allclose(m, jm, rtol=TOL, atol=1e-15)
            assert abs(v - jv) <= TOL * jv
    rows, l2, ang = acc.compute_accuracy_arrays(torch.as_tensor(full),
                                                red, faces)
    jrows, jl2, jang = jacc.compute_accuracy_arrays(full, red, faces)
    assert_rows(rows, jrows)
    np.testing.assert_allclose(l2, jl2, rtol=TOL, atol=0)
    np.testing.assert_allclose(ang, jang, rtol=TOL, atol=1e-15)
    for name, seq in (("full", full), ("red", red)):
        os.makedirs(tmp_path / name)
        for f in range(len(seq)):
            save_off(str(tmp_path / name / f"pos_{f}.off"), seq[f], faces)
    pats = (str(tmp_path / "full" / "pos_%d.off"),
            str(tmp_path / "red" / "pos_%d.off"))
    frames = range(len(full) + 2)          # the last two are missing
    rows = acc.compute_accuracy(*pats, frames, out_dir=str(tmp_path / "a"))
    jrows = jacc.compute_accuracy(*pats, frames, out_dir=str(tmp_path / "j"))
    assert_rows(rows, jrows)
    assert_rows(rows, acc.compute_accuracy_arrays(full, red, faces)[0])
    with open(tmp_path / "a" / "on_mesh_accuracy.csv") as f:
        mine = f.read()
    with open(tmp_path / "j" / "on_mesh_accuracy.csv") as f:
        assert mine == f.read()
    assert_rows(acc.compute_accuracy(*pats, frames, faces=faces),
                jrows)


def test_compare_npy_files_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 5, 3))
    flip = a * np.array([1, -1, 1, -1])[:, None, None]
    paths = {}
    for name, x in (("a", a), ("flip", flip), ("near", a + 1e-7),
                    ("other", a[:3])):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], x)
    np.savez(str(tmp_path / "z.npz"), first=a, second=flip)
    cases = [("a", "near", {}), ("a", "flip", {}),
             ("a", "flip", {"sign_invariant": True}),
             ("a", "near", {"atol": 1e-9}), ("a", "other", {}),
             ("a", "near", {"rtol": 1e-3, "atol": 0.0})]
    for x, y, kw in cases:
        got = cmp.compare_npy_files(paths[x], paths[y], **kw)
        want = jcmp.compare_npy_files(paths[x], paths[y], **kw)
        assert got == want, (x, y, kw)
    z = str(tmp_path / "z.npz")
    for key in (None, "second"):
        assert cmp.compare_npy_files(z, paths["a"], key=key) == \
            jcmp.compare_npy_files(z, paths["a"], key=key)
    for argv in ([paths["a"], paths["near"]],
                 [paths["a"], paths["flip"], "--sign-invariant"],
                 [paths["a"], paths["flip"], "--atol", "1e-3"]):
        assert cmp.main(argv) == jcmp.main(argv)


def test_accuracy_report_gates_match_the_script():
    """The gates and ``check_gates`` of ``scripts/accuracy_report.py``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import accuracy_report as script
    finally:
        sys.path.pop(0)
    assert (report.REL_L2_GATE, report.NORMAL_ANGLE_GATE) == (
        script.REL_L2_GATE, script.NORMAL_ANGLE_GATE)
    for l2, ang in ((3.071e-3, 0.0989), (6.2e-3, 0.2), (1e-5, 1e-4)):
        assert report.check_gates(l2, ang) == script.check_gates(l2, ang)
    for l2, ang in ((6.3e-3, 0.1), (1e-3, 0.21)):
        for fn in (report.check_gates, script.check_gates):
            with pytest.raises(AssertionError, match="regressed past"):
                fn(l2, ang)


def test_report_writes_the_csv_line_and_raises_past_a_gate(tmp_path):
    """``report``: the CSV equals the in-memory measures, the JSON line
    carries the means and the gates, the heat maps and the rotating
    capture are drawn; past a gate the line is emitted with
    ``gate_passed`` false and the report raises."""
    full, red, faces = sequences(F=4)
    lines = []
    out = report.report(full, red, faces, str(tmp_path / "r"),
                        emit=lines.append)
    rows = jacc.compute_accuracy_arrays(full, red, faces)[0]
    with open(tmp_path / "r" / "on_mesh_accuracy.csv") as f:
        written = [{"frame": int(r["frame"]), "rel_l2": float(r["rel_l2"]),
                    "normal_angle": float(r["normal_angle"])}
                   for r in csv.DictReader(f)]
    assert_rows(written, rows)
    line = json.loads(lines[0])
    assert line == out["line"]
    mean_l2 = float(np.mean([r["rel_l2"] for r in rows]))
    assert line["value"] == round(mean_l2, 6)
    assert line["detail"]["frames"] == 4 and line["detail"]["gate_passed"]
    assert len(line["detail"]["heatmaps"]) == 3 * 2 + 8
    for name in line["detail"]["heatmaps"][:6]:
        assert os.path.exists(tmp_path / "r" / name)
    assert len(os.listdir(tmp_path / "r" / "rotation")) == 8
    lines.clear()
    with pytest.raises(AssertionError, match="regressed past"):
        report.report(full, full + 0.2, faces, str(tmp_path / "bad"),
                      draw=False, emit=lines.append)
    assert json.loads(lines[0])["detail"]["gate_passed"] is False


def test_accuracy_report_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``main(["--cpu"])`` end to end on a 10x10 bench cloth (the script's
    flow: record, bases, reduced replay of the recorded window in float64,
    the report), and the bench model at 12 rows against ``bench.py``'s."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.pop(0)
    from animsnapbases_tpu.geometry.procedural import (
        cloth_model as jax_cloth,
    )

    V, F = jax_cloth(12, 12)
    V = V / 12.0
    V[:, 2] += 0.05 * V[:, 0]
    V = V - V.mean(axis=0)
    V = V / np.abs(V).max()
    want = bench.build_model(V, F)
    monkeypatch.setattr(report, "CLOTH_ROWS", 12)
    got = report.bench_model()
    np.testing.assert_allclose(got.positions, want.positions, rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(got.fixed_flags, want.fixed_flags)
    np.testing.assert_array_equal(got.mass, want.mass)
    assert sorted(got.groups) == sorted(want.groups)

    monkeypatch.setattr(report, "CLOTH_ROWS", 10)
    monkeypatch.setattr(report, "FOM_FRAMES", 12)
    monkeypatch.setattr(report, "CONSTR_MODES", 8)
    monkeypatch.setattr(report, "SERVED_MODES", 6)
    monkeypatch.setattr(report, "POS_MODES", 10)
    assert report.main(["--cpu", "--out", str(tmp_path / "acc")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "on_mesh_accuracy_mean_rel_l2"
    assert line["detail"]["frames"] == 12 and line["detail"]["gate_passed"]
    assert os.path.exists(tmp_path / "acc" / "on_mesh_accuracy.csv")


# ---------------------------------------------------------------------------
# the diagnostics and the figures
# ---------------------------------------------------------------------------

def test_plots_pca_matches_jax(tmp_path):
    """``plots_pca`` on the same position components in both packages:
    the same sparsity, rank check and singular values, the same CSV, the
    figure written; ``pca_diagnostics`` gives them without drawing."""
    from animsnapbases_tpu.analysis.figures import plots_pca as jax_plots
    from animsnapbases_tpu.bases.pca import PositionComponents as JaxPC
    from animsnapbases_tpu_torch.analysis.figures import (
        pca_diagnostics,
        plots_pca,
    )
    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from test_bases_pos import _write_config_and_data

    jparam = _write_config_and_data(tmp_path)
    param = BasesConfig.from_dict(jparam.raw,
                                  results_dir=str(tmp_path / "results"))
    bases = PositionComponents(param, device="cpu")
    ref = JaxPC(jparam)
    for b in (bases, ref):
        b.compute_components_store_singvalues()
        b.post_process_components()
    got = plots_pca(bases, param, out_dir=str(tmp_path / "port"))
    want = jax_plots(ref, jparam, out_dir=str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert os.path.exists(got["figure"])
    np.testing.assert_array_equal(got["sparsity"], want["sparsity"])
    assert got["linear_independent"] == want["linear_independent"]
    np.testing.assert_allclose(got["sing_vals"], want["sing_vals"],
                               rtol=1e-9)
    a = np.loadtxt(tmp_path / "port" / "posBases_singvals.csv",
                   delimiter=",", skiprows=1)
    b = np.loadtxt(tmp_path / "jax" / "posBases_singvals.csv",
                   delimiter=",", skiprows=1)
    np.testing.assert_allclose(a, b, rtol=1e-9)
    d = pca_diagnostics(bases, param, out_dir=str(tmp_path / "nodraw"))
    np.testing.assert_array_equal(d["sing_vals"], got["sing_vals"])
    assert os.listdir(tmp_path / "nodraw") == ["posBases_singvals.csv"]


def test_plots_nonlinearity_basis_matches_jax(tmp_path, monkeypatch):
    """``plots_nonlinearity_basis`` on the same recording's constraint
    bases in both packages (``pod_vectorized`` + row DEIM, orthogonalized,
    and ``pca_blocks`` + block DEIM): the same convergence rows, CSVs and
    checks on the same components, the figures written;
    ``nonlinearity_diagnostics`` gives the
    rows and CSVs without drawing."""
    from animsnapbases_tpu.analysis.figures import (
        plots_nonlinearity_basis as jax_plots,
    )
    from animsnapbases_tpu.bases.constraints import (
        ConstraintComponents as JaxCC,
    )
    from animsnapbases_tpu.config.bases_config import BasesConfig as JaxBC
    from animsnapbases_tpu_torch.analysis.figures import (
        nonlinearity_diagnostics,
        plots_nonlinearity_basis,
    )
    from animsnapbases_tpu_torch.bases.constraints import (
        ConstraintComponents,
    )
    from animsnapbases_tpu_torch.bases.pipeline import (
        group_basis_config,
        record_fom,
    )
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig

    monkeypatch.setattr(report, "CLOTH_ROWS", 7)
    model = report.bench_model()
    f = np.zeros_like(model.positions)
    f[:, 1] = -98.1
    record = str(tmp_path / "FOM")
    record_fom(model, f, record, 14, 5, 0.016, 2e-3, device="cpu")
    cases = [("pod_vectorized", "deim", "_Standarized"),
             ("pca_blocks", "deim_block_form", "_nonStandarized")]
    for btype, itype, std in cases:
        base = group_basis_config(record, "tris_strain", 2, 6, 12,
                                  str(tmp_path / btype))
        raw = base.raw
        raw["constraintProj_bases"].update(
            basis_type=btype, interpolation_type=itype, standarized=std)
        out = {}
        for jax in (True, False):
            BC = JaxBC if jax else BasesConfig
            param = BC.from_dict(raw, results_dir=str(
                tmp_path / btype / ("jax" if jax else "port")))
            param.constProj_input_snapshots_pattern = (
                base.constProj_input_snapshots_pattern)
            param.constProj_weightedSt = base.constProj_weightedSt
            param.ensure_dirs()
            cc = JaxCC(param) if jax else ConstraintComponents(
                param, device="cpu")
            cc.nonlinearSnapshots.config()
            cc.config()
            cc.nonlinearSnapshots.snapshots_prepare()
            cc.compute_components_store_singvalues()
            cc.post_process_components()
            if itype == "deim":
                cc.deim()
            else:
                cc.deim_blocksForm()
            if not jax:
                # the JAX package's bases, so that the diagnostics read the
                # same components (a standardized mode follows its sign)
                for key in ("comps", "geom_alpha", "geom_Pt",
                            "geom_alpha_ranges", "geom_interpol_verts"):
                    setattr(cc, key, getattr(out[True][1], key))
            pca = btype == "pca_blocks"
            plots = jax_plots if jax else plots_nonlinearity_basis
            out[jax] = (param, cc, plots(cc, pca_tests=pca, steps=2))
        (jp, jcc, want), (pp, pcc, got) = out[True], out[False]
        assert sorted(got) == sorted(want), btype
        for key in ("pca_figure", "convergence_figure", "elements_figure"):
            assert (key in got) == (key in want)
            if key in got:
                assert os.path.exists(got[key])
        np.testing.assert_array_equal(pcc.geom_Pt, jcc.geom_Pt)
        for case in ("train", "test"):
            np.testing.assert_allclose(np.array(got["convergence"][case]),
                                       np.array(want["convergence"][case]),
                                       rtol=1e-8, atol=1e-12)
        np.testing.assert_array_equal(got["sparsity"], want["sparsity"])
        assert got["linear_independent"] == want["linear_independent"]
        assert got.get("utmu_orthogonal") == want.get("utmu_orthogonal")
        for name in sorted(os.listdir(jp.constProj_output_directory)):
            if name.endswith(".csv"):
                a = np.loadtxt(os.path.join(jp.constProj_output_directory,
                                            name), delimiter=",", skiprows=1)
                b = np.loadtxt(os.path.join(pp.constProj_output_directory,
                                            name), delimiter=",", skiprows=1)
                np.testing.assert_allclose(b, a, rtol=1e-8, atol=1e-12)
        d = nonlinearity_diagnostics(pcc, pca_tests=False, steps=2,
                                     out_dir=str(tmp_path / btype / "nd"))
        np.testing.assert_array_equal(np.array(d["convergence"]["train"]),
                                      np.array(got["convergence"]["train"]))
        assert not [n for n in os.listdir(tmp_path / btype / "nd")
                    if n.endswith(".png")]


def test_viewers_write_pngs(tmp_path):
    """Every renderer of ``analysis/viewer.py``, the heat maps and
    ``visualize_interpolation_elements_from_bin`` write their PNGs."""
    from animsnapbases_tpu_torch.analysis import viewer
    from animsnapbases_tpu_torch.geometry.procedural import bar_model
    from animsnapbases_tpu_torch.io.binfmt import write_points_vector
    from animsnapbases_tpu_torch.io.h5anim import (
        write_animation_h5,
        write_components_h5,
    )
    from animsnapbases_tpu_torch.io.meshes import save_medit_mesh, save_obj

    full, red, faces = sequences(F=3)
    h5 = str(tmp_path / "anim.h5")
    write_animation_h5(h5, full.astype(np.float32), faces)
    assert len(viewer.view_anim_file(h5, frames=[0, 2])) == 2
    comps = str(tmp_path / "comps.h5")
    write_components_h5(comps, full[0], faces, red - full)
    assert len(viewer.view_components(comps, components=[0, 1])) == 2
    out = str(tmp_path / "sel.png")
    assert viewer.view_interpolation_elements(
        full[0], faces, [0, 3], out, max_background_faces=10) == out
    edges = np.array([[0, 1], [1, 2]])
    assert os.path.exists(viewer.view_interpolation_elements(
        full[0], edges, [1], str(tmp_path / "edges.png")))
    assert len(viewer.view_rotating_capture(
        full[0], faces, str(tmp_path / "rot"), selected=[1, 2],
        interpol_verts=[0, 5], num_frames=2)) == 2
    assert len(viewer.view_rotating_capture(
        full[0], faces, str(tmp_path / "rot_e"), selected=[0],
        element_kind="edges", edges=edges, num_frames=1)) == 1
    V, T, Fb, _ = bar_model(3, 2, 2)
    for kind in ("verts", "edges", "tris", "tets"):
        path = viewer.view_element_selection(
            V, Fb, [0, 1], element_type=kind,
            out_path=str(tmp_path / f"{kind}.png"), tets=T,
            max_background_faces=8)
        assert os.path.exists(path)
    with pytest.raises(ValueError, match="unknown element_type"):
        viewer.view_element_selection(V, Fb, [0], element_type="x",
                                      out_path=str(tmp_path / "x.png"))
    maps = acc.compute_accuracy_arrays(full, red, faces)[1]
    assert len(acc.render_error_heatmaps(red, faces, maps,
                                         str(tmp_path / "heat"),
                                         [0, 2])) == 2
    obj, mesh = str(tmp_path / "m.obj"), str(tmp_path / "m.mesh")
    save_obj(obj, V, Fb)
    save_medit_mesh(mesh, V, tets=T, tris=Fb)
    base = str(tmp_path / "alpha")
    alpha = write_points_vector(base, 1, 2, np.array([0, 2]))
    for path, kind in ((obj, "tris"), (mesh, "tets"), (mesh, "edges")):
        assert os.path.exists(acc.visualize_interpolation_elements_from_bin(
            path, alpha, alpha, str(tmp_path / f"bin_{kind}.png"),
            element_kind=kind))


def test_read_points_vector_reads_the_jax_files(tmp_path):
    from animsnapbases_tpu.io import binfmt as jbin
    from animsnapbases_tpu_torch.io.binfmt import read_points_vector

    pts = np.array([3.0, 1.0, 4.0, 1.0, 5.0])
    path = jbin.write_points_vector(str(tmp_path / "p"), 2, 3, pts)
    np.testing.assert_array_equal(read_points_vector(path),
                                  jbin.read_points_vector(path))
    vec = jbin.write_vector(str(tmp_path / "v"), pts)
    np.testing.assert_array_equal(read_points_vector(vec), pts)


def test_store_snapshots_animations_matches_jax(tmp_path, monkeypatch):
    """The p-snapshots through S^T as a components ``.h5`` in both
    packages."""
    from animsnapbases_tpu.io.h5anim import read_components_h5 as jread
    from animsnapbases_tpu.snapshots.nonlinear import (
        NonlinearSnapshots as JaxNS,
    )
    from animsnapbases_tpu_torch.bases.pipeline import (
        export_mesh,
        group_basis_config,
        record_fom,
    )
    from animsnapbases_tpu_torch.snapshots.nonlinear import (
        NonlinearSnapshots,
    )

    monkeypatch.setattr(report, "CLOTH_ROWS", 5)
    model = report.bench_model()
    f = np.zeros_like(model.positions)
    f[:, 1] = -98.1
    record = str(tmp_path / "FOM")
    record_fom(model, f, record, 6, 3, 0.016, 2e-3, device="cpu")
    param = group_basis_config(record, "edge_spring", 1, 4, 5,
                               str(tmp_path / "w"))
    export_mesh(report.bench_model(), param)
    out = []
    for cls in (JaxNS, NonlinearSnapshots):
        ns = cls(param)
        ns.config()
        ns.snapshots_prepare()
        out.append(ns.store_snapshots_animations(str(tmp_path),
                                                 cls.__module__ + ".h5"))
    a, b = jread(out[0]), jread(out[1])
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-12)
