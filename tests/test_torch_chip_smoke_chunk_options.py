"""``chip_smoke.chunk_options`` (kernel 5's other builds) rehearsed on the
CPU with the fakes of ``tests/test_torch_chip_smoke.py``, after the bench
scene's main path: each build on its own path (no launches counted here:
the plain versions run), timed beside the default build, with its
source."""

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    BUILDS,
    assert_entries,
    bench,
    one_thread,
)


def test_chip_smoke_chunk_options_phase(monkeypatch):
    counted, b = bench(monkeypatch)
    options, exact_us_bench = cs.chunk_options(
        torch, counted, b.paths, b.solver, b.model, b.f, b.rest,
        b.main_state)
    assert_entries(options, BUILDS)
    for k in options:
        assert k["launches"] >= 0 and k["default_ms"] > 0, k["name"]
    assert options[0]["source"].endswith("affine_chunked_free.cu")
    assert options[2]["source"].endswith("affine_chunked_opts.cu")
    assert exact_us_bench is not None
