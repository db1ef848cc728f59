"""The plain bases maker and the reference against the program's
``device="cpu"`` path, on a 10 x 10 cloth and an 8 x 3 x 3 bar, float64."""

import json

import numpy as np
import pytest

from portbench import core
from portbench.reference import bases
from portbench.reference.reduced import ReducedReference, tf32_round
from portbench.reference.scene import build_scene
from portbench.tests.tiny import tiny_root

KEYS = {"tris_strain": "faces", "edge_spring": "edges",
        "tets_deformation_gradient": "elements"}


def setup(tmp_path, name):
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "portbench/configs" / f"{name}.json")
                     .read_text())
    made = bases.make(cfg)
    scene = build_scene(cfg)
    model = core.program_model(scene, cfg)
    args = core.program_args(cfg, made)
    solver = core.program_solver(cfg, args, "cpu")
    solver.set_model(model)
    solver.prepare(args)
    return cfg, made, scene, model, solver


@pytest.mark.parametrize("name", ["cloth120_strain_spring",
                                  "bar40x5x5_defgrad"])
def test_reference_follows_the_program(tmp_path, name):
    cfg, made, scene, model, solver = setup(tmp_path, name)
    for g, grp in scene.groups.items():
        assert np.array_equal(model.groups[g].data[KEYS[g]],
                              grp.data[KEYS[g]])
    assert np.array_equal(model.fixed_flags, scene.pinned)
    P0 = scene.positions.copy()
    V0 = 0.1 * made["tail_velocity"]
    F = np.zeros_like(P0)
    model.positions, model.velocities = P0.copy(), V0.copy()
    solver.run_steps(F, 8, num_iterations=cfg["iterations"])
    ref = ReducedReference(scene, cfg, made["dir"], made["pos"]).rollout(
        P0[None], V0[None], F[None], 8)
    # float64 on both sides; the pinned masses (1e10) make the step map
    # amplify rounding, ~1e-12 a step on these scenes
    gap = core.gaps(ref, [(model.positions, model.velocities)])
    assert ref["disp"][0] > 0 and ref["clamp_steps"][0] == 0
    assert gap["pos_gap"] < 1e-6, gap


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0],
                     dtype=torch.float32)
    y = tf32_round(x)
    assert y[0] == 1.0 + 2 ** -10          # a tie rounds away from zero
    assert y[1] == 1.0 + 2 ** -10
    assert y[2] == -3.0


def test_bases_are_cached_and_deterministic(tmp_path):
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "portbench/configs/cloth120_strain_spring.json")
                     .read_text())
    first = bases.make(cfg)
    again = bases.make(cfg)
    assert again["seconds"] == 0.0 and again["dir"] == first["dir"]
    comps = np.load(f"{first['dir']}/tris_strain/basis.npz")
    Pt, alphas, ranges = bases.deim_rows(comps["components"], 2)
    assert np.array_equal(Pt, comps["Pt"]) and np.array_equal(
        alphas, comps["interpol_alphas"])
    assert len(np.unique(Pt)) == len(Pt)
