"""``chip_smoke.scale_phase`` (the megacloth on the large-model route)
rehearsed on the CPU with the fakes of ``tests/test_torch_chip_smoke.py``
at 144 vertices: kernels 2 and 5 (both builds) under ``megacloth``, the
near-floor window's tier-1 calls, kernel 5's plan at the megacloth's
widths."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    PLAN_KEYS,
    one_thread,
    rehearsal,
)


def test_chip_smoke_scale_phase(monkeypatch):
    counted, dev = rehearsal(monkeypatch)
    mega = cs.scale_phase(torch, counted, {}, dev)
    for name in ("resident_multistep", "affine_chunked",
                 "affine_chunked[floor_exact=False]",
                 "affine_chunked_batched[floor_exact=False]"):
        assert mega[name], name
    assert mega["affine_chunked[floor_exact=False]"][
        "near_floor_tier1_calls"][0] > 0
    assert PLAN_KEYS <= set(mega["staging_plan"])
    assert {"exact_check_us", "empty_chunk_us", "prepare_s"} <= set(mega)
