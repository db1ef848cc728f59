"""``chip_smoke.position_phase`` (phase [10]: the position-bases workflow)
rehearsed on the CPU with the fakes of ``tests/test_torch_chip_smoke.py``
on the smallest cloth (14x14): phase [6]'s recording and bases in a shared
directory, then phase [10]'s recording of 16 frames (its first 12 held bit
for bit against phase [6]'s), 8 of them imported and aligned, global and
local PCA with 6 components and 2 SPLOCS iterations, each held against the
CPU's float64 run, the post-processed components served as the position
basis (kernels 1 and 5 on their plain versions, a counted path), the
holds and times of kernels 1 and 5 and the kernels' entries under
``position_bases``."""

import tempfile

import torch

import chip_smoke as cs
from test_torch_chip_smoke import (  # noqa: F401
    KEYS,
    one_thread,
    rehearsal,
)


def test_chip_smoke_position_phase(monkeypatch, capsys):
    counted, dev = rehearsal(monkeypatch)
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        real = cs.pipeline_phase(torch, counted, paths, dev, work=work)
        out = cs.position_phase(torch, counted, paths, dev, "cpu, 0 W",
                                work, real["affine_chunked"]["vs_fom"])
    assert sorted(out) == ["affine_chunked", "fused_reduced_iterations"]
    for name, entry in out.items():
        assert KEYS - {"name", "route", "source", "replaces"} <= set(entry)
        assert entry["bound_ms"] > 0 and entry["r"] == 6
        # the plain versions count no launch
        assert entry["launches"] == paths[entry["launches_path"]][name]
        assert set(entry["vs_fom"]) == {"mean", "p99", "max"}
        assert set(entry["stage_s"]) == {
            "record", "align", "geodesic prefactor", "global PCA",
            "local PCA", "SPLOCS", "post-process", "prepare", "serve"}
    holds = out["affine_chunked"]["holds"]
    assert holds["align"]["vs_cpu"] <= cs.POSB_EXTENT
    # the 14x14 cloth hangs in its plane: every frame takes the rank-2 rule
    assert holds["align"]["rank2_frames"] == 8
    for stage in ("global PCA", "local PCA"):
        assert 0 < holds[stage]["steps_above_cut"] <= 6
        assert holds[stage]["parted"] is None
        assert holds[stage]["reconstruction"] <= cs.POSB_EXTENT
    assert len(holds["SPLOCS"]["energy"]) == 2
    assert holds["SPLOCS"]["iterations_replayed"] == 2
    text = capsys.readouterr().out
    for line in ("[10] position bases: configs/examples/bunny_gFall_pos"
                 "Subspace.json", "reduced: [\"the bunny mesh",
                 "its first 12 frames equal phase [6]'s recording bit for "
                 "bit: True", "[10] position bases, global PCA (6 "
                 "components, the CPU's run 6 steps): the card's steps "
                 "equal the CPU's", "[10] position bases, local PCA (6 "
                 "components, the CPU's run 6 steps)", "[10] position "
                 "bases, SPLOCS (2 iterations on the card and the CPU)",
                 "is_utmu_orthogonal True",
                 "phase [6]'s POD basis: mean",
                 "position bases, kernel 5 (hang state under gravity), "
                 "carried steps", "[10] position bases seconds (cpu, 0 W)"):
        assert line in text, line


def test_greedy_holds_part_only_where_rounding_sets_the_choice(monkeypatch):
    """``chip_smoke.greedy_holds`` on a local-support extraction of the
    JAX test's synthetic cloth: the same run on both sides passes and
    compares the reconstruction; a pick that is no tie, or the same pick
    with a residual that departs at a step whose cone sides are both real,
    fails."""
    import copy

    import numpy as np

    from animsnapbases_tpu_torch.bases.pca import PositionComponents
    from animsnapbases_tpu_torch.config.bases_config import BasesConfig
    from animsnapbases_tpu_torch.snapshots.position import PositionSnapshots
    from test_bases_pos import synthetic_cloth_animation

    anim, faces = synthetic_cloth_animation()
    snaps = PositionSnapshots.from_arrays(anim, faces)
    param = BasesConfig.from_json(cs.POSB_CONFIG, results_dir="unused")
    param.q_support, param.vertPos_numComponents = "local", 6
    cpu = PositionComponents(param, snaps, device="cpu")
    cpu.extract_k_components()
    R0 = torch.as_tensor(snaps.snapTensor)
    verdicts = []
    monkeypatch.setattr(cs, "require", lambda ok, what: verdicts.append(
        (ok, what)))

    out = cs.greedy_holds("same", copy.deepcopy(cpu), cpu, R0)
    assert all(ok for ok, _ in verdicts) and out["parted"] is None
    assert out["steps_held"] == 6 and out["reconstruction"] == 0.0

    # the CPU's run of 4 steps against the card's 6: those steps held, the
    # reconstructions not compared
    short = copy.deepcopy(cpu)
    short.picks = cpu.picks[:4]
    short.measures_at_largeDeforVerts = cpu.measures_at_largeDeforVerts[:4]
    short.numComp = 4
    out = cs.greedy_holds("cut", copy.deepcopy(cpu), short, R0)
    assert all(ok for ok, _ in verdicts) and out["parted"] is None
    assert out["steps_replayed"] == 4 and out["steps_held"] == 4
    assert out["reconstruction"] is None

    other = copy.deepcopy(cpu)
    other.picks[2] = (cpu.picks[2] + 7) % len(anim[0])
    out = cs.greedy_holds("pick", other, cpu, R0)
    assert out["parted"]["why"] == "pick tie" and out["steps_held"] == 2
    assert out["parted"]["shortfall"] > cs.POSB_TIE
    assert [ok for ok, w in verdicts if "where rounding does not" in w] == [False]

    other = copy.deepcopy(cpu)
    other.measures_at_largeDeforVerts[3, 2] *= 1.0 + 1e-6
    out = cs.greedy_holds("side", other, cpu, R0)
    assert out["parted"]["why"] == "cone side set by rounding"
    assert min(out["parted"]["positive_side"],
               out["parted"]["negative_side"]) > cs.POSB_NOISE
    assert [ok for ok, w in verdicts if "where rounding does not" in w] == [False, False]

    sides = cs.cone_sides(torch.tensor([-1.0, -0.5, 1e-17, 0.0],
                                       dtype=torch.float64))
    assert sides == (1e-17, 1.0)
    assert np.isclose(cs.cone_sides(torch.tensor([2.0, -1.0]))[1], 0.5)

