"""``chip_smoke.py``'s phases [1]-[5] on the bench scene, rehearsed on the
CPU with the fakes of ``tests/test_torch_chip_smoke.py``: the build, the
main path, the tiered runs and the small scene, the kernels against their
plain versions, the times, and the six solo kernels' entries of the
kernels line with their staging plans, kernel 1's device time and kernel
5's slope and intercept."""

import torch

import chip_smoke as cs
from animsnapbases_tpu_torch.ops import cluster
from test_torch_chip_smoke import (  # noqa: F401
    PLAN_KEYS,
    SOLO,
    assert_entries,
    bench,
    one_thread,
)


def test_chip_smoke_bench_phases(monkeypatch, capsys):
    counted, b = bench(monkeypatch)
    assert cs.build_phase(torch) == "cpu, 0 W"
    cs.tiers_phase(torch, counted, b)
    kernels = cs.times_phase(torch, b, cs.holds_phase(torch, b))
    assert_entries(kernels, SOLO)
    # kernels 1 and 5 on the cluster loop: the staging plans of their
    # widths, kernel 1's device time and the loop's slope and intercept;
    # the operations' floor on the cluster's SMs is computed, not
    # measured, and stays out of the kernels line
    k1, k5 = kernels[0], kernels[4]
    for k in kernels[:4] + kernels[4:]:
        assert PLAN_KEYS | {"resident_clusters"} <= set(k["staging_plan"])
        assert not any(key.startswith("cluster_floor") for key in k)
    assert k1["staging_plan"]["staged"] and k5["staging_plan"]["staged"]
    for k in (k1, k5):
        assert k["staging_plan"]["cluster"] == [3, 1, 1]
        assert 0 < k["staging_plan"]["smem_bytes"] <= cluster.SMEM_MAX
    assert {"device_ms", "device_us_per_iteration",
            "device_intercept_us"} <= set(k1)
    assert {"us_per_iteration", "intercept_us_per_step",
            "window_us_per_iteration",
            "window_intercept_us_per_step"} <= set(k5)
    assert kernels[5]["recursion_drift"]
    assert b.paths["main path"] is not None
    out = capsys.readouterr().out
    assert "on the cluster's 3 SMs" in out
    assert "kernel 1: staging plan" in out and "kernel 5: staging plan" in out
    assert "kernel 2: staging plan" in out
    assert "kernels 3 and 4: staging plan" in out
    assert "clusters resident at once" in out
    assert "[2] small scene, card f32 vs CPU f64 plain" in out
