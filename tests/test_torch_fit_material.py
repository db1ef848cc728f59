"""The material-fit demo of the PyTorch port
(``python -m animsnapbases_tpu_torch.demos.fit_material --cpu``) in
process on the CPU, float64: the twin experiment of ``scripts/
fit_material.py`` (the 8x8 cloth recorded for 30 frames, 10 modes a
group, r = 14, true scales edge_spring 1.6 and tris_strain 0.55, 150 Adam
steps over a 16-step horizon) end to end through the port's own pipeline.
It must pass the script's ``ok``: every scale within 0.1 relative of the
truth and the loss down 1e3 times (measured on a CPU: 2.4e-4 relative,
loss 2.9e-5 -> 1.1e-12, ~150 s on one thread)."""

import json

import pytest
import torch

from animsnapbases_tpu_torch.demos import fit_material


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_twin_experiment_recovers_the_scales(capsys):
    assert fit_material.main(["--cpu"]) == 0
    data = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert data["metric"] == "material_fit_max_rel_scale_error"
    assert {"value", "unit", "vs_baseline", "detail"} <= set(data)
    d = data["detail"]
    assert d["device"] == "cpu" and d["groups"] == ["edge_spring",
                                                   "tris_strain"]
    assert d["true_scales"] == [1.6, 0.55]
    assert d["adam_steps"] == 150 and d["horizon"] == 16 and d["r"] == 14
    assert data["value"] < 0.1
    assert d["loss_last"] < 1e-3 * d["loss_first"]
