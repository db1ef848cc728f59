"""``chip_smoke.ensemble`` (ensemble serving) rehearsed on the CPU with the
fakes of ``tests/test_torch_chip_smoke.py``, after the bench scene's main
path: the six batched kernels' entries of the kernels line (kernel 4's
batched build, row 4b, the last), batched kernel 1's device time, and the
batched builds' staging plan at each batch size."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    BATCHED,
    assert_entries,
    bench,
    one_thread,
)


def test_chip_smoke_ensemble_phase(monkeypatch):
    counted, b = bench(monkeypatch)
    kernels = cs.ensemble(torch, counted, b.solver, b.model, b.f,
                          b.main_state, b.paths)
    assert_entries(kernels, BATCHED)
    assert "device_ms" in kernels[0]
    for k in (kernels[1], kernels[2], kernels[4]):
        by_sims = k["staging_plan_by_sims"]
        assert {str(B) for B in by_sims} == {str(B) for B in cs.ENSEMBLE_SIZES}
        assert all(v["waves"] >= 1 for v in by_sims.values())
    for k in kernels:
        assert not any(key.startswith("cluster_floor") for key in k)
    assert kernels[4]["launches_path"].startswith(
        "make_batched_run, B=4 ring-down, default")
    k4b = kernels[5]
    assert k4b["replaces"].endswith("pallas_resident.py:1122 (nb > 1)")
    assert k4b["launches_path"].startswith("batched kernel 4, launched")
    assert 0 < k4b["whole_batch_k"] == min(k4b["solo_k"]) < cs.SCENE_STEPS
    assert set(k4b["window_us_per_step_by_sims"]) == {1, 2, 4}
