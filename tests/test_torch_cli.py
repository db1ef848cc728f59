"""The port's two command lines against the JAX package's on the CPU in
float64: ``sim_cli`` (``--list``, a recorded scenario, the card by
default) and the bases CLI (``cli.main``: the whole loop of record ->
bases config -> npz, CSVs, figures and timings; ``cli.cli``), small
scenes, torch on one thread."""

import csv
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_scenarios import EXTENT_TOL, one_thread, small_args  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = ("components_interpol_alphas_interpol_verts_interpol_alpha_ranges"
       ".npz")


def small_config(tmp_path, cloth=6):
    """testing.json with a ``cloth`` x ``cloth`` cloth -> its path."""
    with open(os.path.join(REPO, "configs", "demos", "testing.json")) as f:
        cfg = json.load(f)
    cfg["system"]["Cloth"] = {"cloth_width": cloth, "cloth_height": cloth}
    path = tmp_path / "small.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_sim_cli_list_prints_the_jax_lines():
    from animsnapbases_tpu.sim_cli import cli as jax_cli
    from animsnapbases_tpu_torch.sim_cli import cli

    out = []
    for fn in (jax_cli, cli):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(["--list"]) is None
        out.append(buf.getvalue())
    assert out[0] == out[1] and "cloth_automated_bend_spring_strain" in out[1]


def test_sim_cli_records_as_jax(tmp_path):
    """``--record --record-positions --max-frames`` through both CLIs: the
    same trajectory, p-snapshots and ``.off`` files."""
    from animsnapbases_tpu.sim_cli import cli as jax_cli
    from animsnapbases_tpu_torch.sim_cli import cli

    config = small_config(tmp_path)
    drivers = []
    for fn, sub in ((jax_cli, "jax"), (cli, "port")):
        drivers.append(fn(["--example", "cloth_automated_bend_spring_strain",
                           "--config", config, "--solver", "Solver",
                           "--record", "--record-positions", "--max-frames",
                           "22", "--output", str(tmp_path / sub), "--cpu"]))
    jd, pd = drivers
    A, P = np.array(jd.trajectory), np.array(pd.trajectory)
    assert A.shape == P.shape == (22, 36, 3)
    assert float(np.abs(A - P).max()) <= EXTENT_TOL * float(np.abs(A).max())
    assert sorted(os.listdir(pd.pos_dir)) == sorted(os.listdir(jd.pos_dir))
    for name in sorted(os.listdir(jd.record_path)):
        a = np.load(os.path.join(jd.record_path, name), allow_pickle=True)
        b = np.load(os.path.join(pd.record_path, name), allow_pickle=True)
        assert a.files == b.files, name


def test_entry_points_default_to_the_card(tmp_path):
    """``sim_cli``, the bases CLI and the accuracy report take the card:
    without one they raise (``--cpu`` asks for the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    from animsnapbases_tpu_torch import cli as bases_cli
    from animsnapbases_tpu_torch import sim_cli
    from animsnapbases_tpu_torch.analysis import accuracy_report

    with pytest.raises(RuntimeError, match="device='cpu'"):
        sim_cli.cli(["--example", "cloth_automated_strain", "--config",
                     small_config(tmp_path), "--max-frames", "2",
                     "--output", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bases_cli.cli(["--config_file", os.path.join(
            REPO, "configs", "examples",
            "cloth_automated_deim_triStrainSubspace.json"),
            "--results_dir", str(tmp_path / "results")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accuracy_report.main(["--out", str(tmp_path / "acc")])


def _loop_config(out_dir, record_path):
    return {
        "object": {"experiment_dir": out_dir + "/", "mesh": "cloth",
                   "volumetric": False,
                   "experiment": "cloth_automated_snapshots",
                   "snap_format": ".off"},
        "vertexPos_bases": {"computeState": {"compute": False}},
        "constraintProj_bases": {
            "computeState": {"compute": True, "run_main": True,
                             "testingComputations": "_Release"},
            "constraintType": {
                "name": "tris_strain", "elements": "_tris",
                "p_snaps_folder": "/x",
                "assembly_file_name": "assembly_ST.npz",
                "assembly_key": "tris_strain",
                "snaps_pattern_full_p": "/tris_strain_p.npz",
                "constrained_elements": "", "rowSize": 2},
            "snapshots": {"numFrames": 14, "frame_increment": 2,
                          "preAlignement": "_noAlignement",
                          "reduced_snaps_available": False},
            "basis_type": "pod_vectorized", "interpolation_type": "deim",
            "desired_num_components": 12, "bases_res_tol": 1e-20, "dim": 3,
            "max_element_per_geom_vert": 10, "rest_shape": "first",
            "massWeighted": "_nonWeighted",
            "standarized": "_nonStandarized", "supported": "_Global",
            "orthogonalized": "_nonOrthogonalized",
            "store_sing_val": True, "store_to_files": True,
            "run_tests": True, "visualize_geom_elements": False,
            "visualize_elements_at_bases_num": 0},
    }


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=float)


def test_full_cli_loop_matches_jax(tmp_path):
    """The sim CLI's scenario records, the bases CLI consumes the
    recording, each package on its own: the npz's components equal the
    JAX package's up to each mode's sign (1e-8), the DEIM picks equal or
    ties of the greedy's argmax, the CSVs within 1e-8 relative, the
    figures and the timings written."""
    from animsnapbases_tpu.cli import main as jax_main
    from animsnapbases_tpu.config.bases_config import BasesConfig as JaxBC
    from animsnapbases_tpu.demos.scenarios import build_scenario as jax_build
    from animsnapbases_tpu_torch.cli import main
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from animsnapbases_tpu_torch.demos.scenarios import build_scenario

    params_out = {}
    for jax in (True, False):
        params, args = small_args(tmp_path, jax=jax,
                                  vert_bending_constraint=False)
        build = jax_build if jax else build_scenario
        kw = {} if jax else {"device": "cpu"}
        d = build("cloth_snapshots", args, record_fom_info=True,
                  params=params, record_positions=True,
                  poking_frames_per_point=8, rest_frames_per_point=4,
                  number_pokes=2, **kw)
        d.run()
        assert d.solver.frame == 28
        BC = JaxBC if jax else BasesConfig
        param = BC.from_dict(_loop_config(args.output_dir, d.record_path),
                             results_dir=str(tmp_path / ("results_jax" if jax
                                                         else "results")))
        param.constProj_input_snapshots_pattern = os.path.join(
            d.record_path, "tris_strain_p.npz")
        param.constProj_weightedSt = os.path.join(d.record_path,
                                                  "assembly_ST.npz")
        results = (jax_main(param) if jax else main(param, device="cpu"))
        params_out[jax] = (param, results["constproj"])

    (jp, jcc), (pp, pcc) = params_out[True], params_out[False]
    jdir, pdir = jp.constProj_output_directory, pp.constProj_output_directory
    a, b = np.load(os.path.join(jdir, NPZ)), np.load(os.path.join(pdir, NPZ))
    assert sorted(a.files) == sorted(b.files) == sorted(
        ["components", "interpol_alphas", "Pt", "interpol_verts",
         "interpol_alpha_ranges"])
    ca, cb = a["components"], b["components"]
    assert ca.shape == cb.shape
    diff = cs.sign_aligned_diff(ca, cb)
    assert diff.max() <= 1e-8
    ok, ties = cs.deim_picks_agree(ca, a["Pt"], b["Pt"], diff)
    assert ok, ties
    if not ties:
        for k in ("interpol_alphas", "Pt", "interpol_alpha_ranges"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    files = sorted(os.listdir(pdir))
    assert files == sorted(os.listdir(jdir))
    assert "function_timings.txt" in files and "time_logs.txt" in files
    assert any(f.endswith(".png") for f in files)
    csvs = [f for f in files if f.endswith(".csv")]
    assert len(csvs) == 3
    for name in csvs:
        ha, va = _read_csv(os.path.join(jdir, name))
        hb, vb = _read_csv(os.path.join(pdir, name))
        assert ha == hb and va.shape == vb.shape, name
        scale = np.maximum(np.abs(va), 1e-300)
        assert float((np.abs(va - vb) / scale).max()) <= 1e-8, name
