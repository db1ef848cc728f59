"""``chip_smoke.tet_bending`` on the switch scene (the bar with tets_strain
and bending, through every tier switch and batched route), rehearsed on
the CPU with the fakes of ``tests/test_torch_chip_smoke.py``: every kernel
timed and bounded on it."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    KEYS,
    PLAN_KEYS,
    SERVED,
    one_thread,
    rehearsal,
)

SCENES = {cs.SWITCH_SCENE}


def test_chip_smoke_tet_bending_switch(monkeypatch):
    counted, _ = rehearsal(monkeypatch)
    per = cs.tet_bending(torch, counted, {}, scenes=SCENES)
    assert set(per) <= set(SERVED)
    for name, entries in per.items():
        for entry in entries.values():
            assert KEYS - {"name", "route", "source", "replaces",
                           "library_ms"} <= set(entry), name
            assert entry["bound_ms"] > 0
    for name in ("fused_reduced_iterations", "affine_chunked"):
        for entry in per[name].values():
            assert PLAN_KEYS <= set(entry["staging_plan"])
    # kernels 1, 5 and 3' (solo and batched) run on every scene
    for name in ("fused_reduced_iterations", "affine_chunked",
                 "resident_affine_contact",
                 "fused_reduced_iterations_batched",
                 "resident_affine_contact_batched"):
        assert sorted(per[name]) == sorted(SCENES), name
    # the switch scene drives every kernel the entry points serve
    assert set(per) == set(SERVED)
