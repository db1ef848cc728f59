"""``chip_smoke.per_group_phase`` (phase [7]: the reference's per-group
workflow) rehearsed on the CPU with the fakes of
``tests/test_torch_chip_smoke.py``, the recordings cut to 12 frames, the
example configs to 5 frames and 4 components, 6 reduced steps: the demo
cloth's six example configs and its two solves (dense), the bench cloth on
phase [6]'s recording and bases (run first) on the host LU and the mixed
path, the bar's block-form bases through kernels
1 and 5; every card-vs-CPU hold, the batched runners on the dense and
mixed solves (each sim against its solo run) and their refusal of the host
LU, the kernels' entries under ``per_group``."""

import tempfile

import torch

import chip_smoke as cs

BENCH = cs.bench_scene
from test_torch_chip_smoke import (  # noqa: F401
    KEYS,
    PLAN_KEYS,
    one_thread,
    rehearsal,
)

SMALL = {"GROUP_FRAMES": 12, "BAR_FRAMES": 12, "GROUP_STEPS": 6,
         "GROUP_OVERRIDES": {"numFrames": 5, "desired_num_components": 4}}


def small(monkeypatch):
    """Phase [7] cut to size, and its bench cloth at 21x21 with the dense
    tier's limit between its 3N (1,323) and the demo's (1,200), so that the
    positions-full solve takes the host LU as the bench scene does."""
    from animsnapbases_tpu_torch.sim import reduced

    for name, value in SMALL.items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(reduced.AnimSnapBasesSolver, "DENSE_LIMIT", 1250)
    monkeypatch.setattr(cs, "bench_scene", lambda cls, cloth: BENCH(
        cls, lambda rows, cols: cloth(21, 21)))


def test_chip_smoke_per_group_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    small(monkeypatch)
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        cs.pipeline_phase(torch, counted, paths, dev, work=work)
        out = cs.per_group_phase(torch, counted, paths, dev, "cpu, 0 W",
                                 work)
    assert sorted(out) == ["affine_chunked", "fused_reduced_iterations"]
    for name, entries in out.items():
        workflow = entries.pop("workflow")
        assert sorted(entries) == ["deim_pca_blocks",
                                   "geom_pca_blocks_withSt"]
        for rtype, entry in entries.items():
            assert (KEYS - {"name", "route", "source", "replaces",
                            "library_ms"}) <= set(entry), (name, rtype)
            assert entry["bound_ms"] > 0
            assert PLAN_KEYS <= set(entry["staging_plan"])
            assert entry["launches_path"] in paths
            assert set(entry["vs_fom"]) == {"mean", "p99", "max"}
            # the block form: three table columns a tet
            assert list(entry["table_columns"]) == [
                "tets_deformation_gradient"]
        assert set(workflow["demo_vs_fom"]) == {"deim_pod_vectorized",
                                                "geom_pca_blocks_withSt"}
        assert set(workflow["bench_vs_fom"]) == {
            "positions full", "positions reduced, edge_spring full"}
        assert set(workflow["batched_vs_solo"]) == {
            "demo, deim bases as deim_pod_vectorized",
            "bench, positions reduced, edge_spring full"}
    text = capsys.readouterr().out
    for line in ("[7] demo: 400 vertices, 4 pinned",
                 "[7] demo, tris_strain, geom: pod_vectorized + geom",
                 "[7] demo, deim bases as deim_pod_vectorized: dense path",
                 "[7] demo, geom bases as geom_pca_blocks_withSt: dense path",
                 "[7] bench, positions full: host path",
                 "[7] bench, positions reduced, edge_spring full: mixed path",
                 "[7] bar, deim_block_form: pca_blocks + deim_block_form",
                 "[7] bar, geom bases as geom_pca_blocks_withSt, kernel 1",
                 "[7] per-group workflow seconds (cpu, 0 W)",
                 "[7] demo, deim bases as deim_pod_vectorized: "
                 "make_batched_run (1 step) at 8 sims on the batched "
                 "full-space step (dense)",
                 "[7] demo, deim bases as deim_pod_vectorized: "
                 "make_batched_step (1 step) at 8 sims",
                 "[7] bench, positions reduced, edge_spring full: "
                 "make_batched_run (4 steps) at 8 sims on the batched "
                 "full-space step (mixed)",
                 "[7] bench, positions reduced, edge_spring full: "
                 "make_batched_step (1 step) at 8 sims",
                 "[7] bench, positions full: make_batched_run and "
                 "make_batched_step raise RuntimeError (the host LU)",
                 "reduced-vs-FOM after 6 steps"):
        assert line in text, line

