"""The smoke battery (``python -m animsnapbases_tpu_torch.smoke``) and the
sweep (``python -m animsnapbases_tpu_torch.sweep``) on the CPU.

The battery's nine checks are rehearsed with the card faked as
``tests/test_torch_chip_smoke.py`` fakes it (the wrappers on their plain
versions), its holds lenient only where the plain versions cannot meet
them (they count no launches, and a batched plain version rounds its sums
otherwise than the solo one), ``chunked_only`` at a lowered
``CHUNKED_TIER1_MIN_VERTS``: the script's own logic, not a kernel.  Without
a card it refuses to run, and it refuses unknown names.  The sweep runs
two example configs as worker processes of the bases CLI (``--cpu``) on a
tiny recording, each output equal to an in-process ``cli.main`` run of the
same config.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from animsnapbases_tpu_torch import holds, smoke, sweep
from animsnapbases_tpu_torch.sim.reduced import AnimSnapBasesSolver
from test_torch_chip_smoke import one_thread, rehearsal  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def battery(monkeypatch):
    """The card faked, the holds lenient where the plain versions cannot
    meet them, the large-model route's threshold at 150 vertices."""
    rehearsal(monkeypatch)
    strict = holds.require

    def require(ok, what):
        if ("never launched" not in what
                and "differs from the solo kernel" not in what):
            strict(ok, what)

    monkeypatch.setattr(holds, "require", require)
    monkeypatch.setattr(AnimSnapBasesSolver, "CHUNKED_TIER1_MIN_VERTS", 150)


@pytest.mark.parametrize("name", list(smoke.CHECKS))
def test_battery_check_rehearsed(monkeypatch, capsys, name):
    battery(monkeypatch)
    assert smoke.main([name], device="cpu") == 0
    out = capsys.readouterr()
    assert out.out.strip().splitlines()[-1].startswith(f"PASS {name} (")
    assert "launches" in out.err


def test_battery_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        smoke.main(["contact"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "animsnapbases_tpu_torch.smoke"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "PASS" not in r.stdout


def test_battery_refuses_unknown_names():
    with pytest.raises(SystemExit, match=r"unknown check\(s\) \['nope'\]"):
        smoke.main(["contact", "nope"])


def test_sweep_matches_the_cli_in_process(tmp_path):
    """Two example configs of a tiny recording (the 6x6 cloth of
    ``cloth_automated_bend_spring_strain``, 22 frames) through the sweep's
    worker processes (``--cpu``, two jobs): each npz equal to an
    in-process ``cli.main`` of the same config (the DEIM picks equal, the
    sign-aligned modes within 1e-9: the workers run their BLAS on their own
    threads), and a config that fails is reported."""
    import chip_smoke as cs
    from animsnapbases_tpu_torch import sim_cli
    from animsnapbases_tpu_torch.bases.pipeline import (
        example_config,
        example_config_file,
    )
    from animsnapbases_tpu_torch.cli import main as cli_main
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from test_torch_cli import NPZ, small_config

    out = str(tmp_path / "fom")
    fom = sim_cli.cli(["--example", "cloth_automated_bend_spring_strain",
                       "--config", small_config(tmp_path), "--solver",
                       "Solver", "--record", "--record-positions",
                       "--max-frames", "22", "--output", out, "--cpu"])
    over = {"numFrames": 5, "desired_num_components": 4, "run_tests": False}
    configs, ref = [], {}
    for tag in ("triStrain", "edgeSpring"):
        example = os.path.join(REPO, "configs", "examples",
                               f"cloth_automated_deim_{tag}Subspace.json")
        param = example_config(example, fom.record_path, out, **over)
        cli_main(param, device="cpu")
        ref[tag] = np.load(os.path.join(param.constProj_output_directory,
                                        NPZ))
        configs.append(example_config_file(
            example, fom.record_path, out, str(tmp_path / f"{tag}.json"),
            **over))
    results = str(tmp_path / "swept")
    assert sweep.main(configs + ["--jobs", "2", "--cpu", "--results_dir",
                                 results]) == 0
    for tag, cfg in zip(("triStrain", "edgeSpring"), configs):
        outd = BasesConfig.from_json(
            cfg, results_dir=results).constProj_output_directory
        got = np.load(os.path.join(outd, NPZ))
        a, b = ref[tag], got
        np.testing.assert_array_equal(a["Pt"], b["Pt"])
        np.testing.assert_array_equal(a["interpol_alphas"],
                                      b["interpol_alphas"])
        assert (cs.sign_aligned_diff(a["components"], b["components"])
                <= 1e-9).all()
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as fp:
        json.dump({"object": {}}, fp)
    assert sweep.main([bad, "--cpu"]) == 1
