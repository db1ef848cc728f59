"""Constraint kinds and scene kinds are files found by name, and a new
configuration (a new scene, per-group widths, a pin schedule, a kind whose
elements have padded corners) takes files and entries alone."""

import json
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import core
from portbench.costs.cell import call_cost
from portbench.reference import bases, fom
from portbench.reference.reduced import ReducedReference
from portbench.reference.scene import build_scene, gravity
from portbench.tests.tiny import ROOT, tiny_root

PB = ROOT / "portbench"
SHARED = ("core.py", "reference/scene.py", "reference/fom.py",
          "reference/reduced.py", "reference/bases.py", "costs/cell.py")
# the program's kinds that have no kind file yet
PROGRAM_KINDS = ("verts_bending", "tets_strain", "positional")

STRIP = '''
import numpy as np


def build(spec):
    """A w x h grid of triangles in the x-z plane, lifted ``hang``; no pins
    of its own."""
    w, h = spec["size"]
    i, j = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    V = np.stack([i.ravel(), 0 * i.ravel(), j.ravel()], axis=1) / max(w, h)
    V[:, 1] += float(spec["hang"])
    c = (np.arange(w - 1)[:, None] * h + np.arange(h - 1)[None]).ravel()
    F = np.concatenate([np.stack([c, c + h + 1, c + 1], 1),
                        np.stack([c, c + h, c + h + 1], 1)])
    return V, F, None, np.zeros(len(V), dtype=bool)
'''

# a kind whose elements are vertex stars of varying valence: each star's
# corners are its centre and its neighbours, padded with the centre and
# masked; the row pulls the star's Laplacian to its rest length
STAR = '''
import numpy as np
import torch

from portbench.reference.scene import coo

p = 1
ROW_FLOPS = 25
PROGRAM = {"method": "none", "kwargs": ["wi"], "group": "none"}


def build(V, F, T, group):
    n, wi = len(V), group["wi"]
    nbrs = [set() for _ in range(n)]
    for a, b in np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]]):
        nbrs[a].add(int(b))
        nbrs[b].add(int(a))
    d = max(len(s) for s in nbrs)
    star = np.repeat(np.arange(n)[:, None], d + 1, axis=1)
    mask = np.zeros((n, d), dtype=bool)
    for v, s in enumerate(nbrs):
        star[v, 1:1 + len(s)] = sorted(s)
        mask[v, :len(s)] = True
    w = mask / mask.sum(axis=1, keepdims=True)
    lap = V - (w[:, :, None] * V[star[:, 1:]]).sum(axis=1)
    s = np.concatenate([np.ones((n, 1)), -w], axis=1) * wi
    e = np.arange(n)
    ST = coo([star[:, k] for k in range(d + 1)], [e] * (d + 1),
             [s[:, k] for k in range(d + 1)], (n, n))
    blk = coo([star[:, a] for a in range(d + 1) for b in range(d + 1)],
              [star[:, b] for a in range(d + 1) for b in range(d + 1)],
              [s[:, a] * s[:, b] / wi for a in range(d + 1)
               for b in range(d + 1)], (n, n))
    return ({"star": star, "mask": mask, "weights": w,
             "rest": np.linalg.norm(lap, axis=1)}, ST, blk)


def corners(data):
    return data["star"]


def rows(corners, data):
    w = data["weights"] * data["mask"]
    lap = corners[..., 0, :] - (w[..., None] * corners[..., 1:, :]).sum(-2)
    norm = torch.linalg.vector_norm(lap, dim=-1, keepdim=True)
    safe = torch.where(norm > 1e-12, norm, torch.ones_like(norm))
    out = lap * data["rest"][..., None] / safe
    return torch.where(norm > 1e-12, out, torch.zeros_like(out))[..., None, :]
'''


def strip_config(root):
    """A configuration of the new scene: per-group widths, its left and
    right sides pinned by the pins rule, the right released at frame 12 of
    the recording."""
    cfg = json.loads((root / "portbench/configs/cloth120_strain_spring.json")
                     .read_text())
    cfg.update(name="strip")
    cfg["scene"] = {"kind": "strip", "size": [9, 7], "hang": 20.0,
                    "mass": 10.0, "floor": True,
                    "pins": {"sides": ["left", "right"]}}
    cfg["recording"].update(frames=40, events=[
        {"frame": 12, "action": "release", "set": "right"}])
    cfg["bases"].update(modes={"tris_strain": 14, "edge_spring": 9},
                        frames=39)
    cfg["served"].update(modes={"tris_strain": 10, "edge_spring": 6},
                         position_modes=24)
    (root / "portbench/reference/scenes/strip.py").write_text(STRIP)
    return cfg


def test_a_kind_is_its_file(tmp_path):
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "portbench/configs/cloth120_strain_spring.json")
                     .read_text())
    path = root / "portbench/reference/kinds/edge_spring.py"
    copy = path.read_bytes()
    path.unlink()
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        build_scene(cfg, root)
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        core.run(root, "cloth120.serve", 2 ** 31 + 41, 0.2, False,
                 device="cpu")
    with pytest.raises(FileNotFoundError, match="no_such_kind.py"):
        call_cost({"n": 10, "r": 2, "n_sel": 3, "rows": {"no_such_kind": 1},
                   "iterations": 1, "matrix_bytes": 4}, 1, 1, root=root)
    path.write_bytes(copy)
    res = core.run(root, "cloth120.serve", 2 ** 31 + 41, 0.2, False,
                   device="cpu")
    assert res["correct"], res["checks"]


def test_a_new_configuration_takes_files_and_entries_only(tmp_path):
    root = tiny_root(tmp_path)
    cfg = strip_config(root)
    (root / "portbench/configs/strip.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "strip", "source": "test",
                            "file": "portbench/configs/strip.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "strip.serve", "config": "strip",
                              "traffic": "ringdown_low", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("strip.serve")
    (root / "portbench/limits/strip.serve.json").write_text(json.dumps(
        {"pos_gap": {"limit": 1e-4}, "vel_gap": {"limit": 1e-4}}))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    scene = build_scene(cfg, root)
    assert scene.pinned.sum() == len(scene.sets["left"]) + len(
        scene.sets["right"]) > 0
    made = bases.make(cfg, root=root)
    for name, k in (("tris_strain", 14), ("edge_spring", 9)):
        comps = np.load(f"{made['dir']}/{name}/basis.npz")["components"]
        assert comps.shape[0] == k
    args = core.program_args(cfg, made, root)
    assert (args.tri_strain_num_components,
            args.edge_spring_num_components) == (10, 6)
    assert core.cost_shape(scene, cfg, made)["rows"] == {
        "tris_strain": 13, "edge_spring": 8}
    res = core.run(root, "strip.serve", 2 ** 31 + 43, 0.2, False,
                   device="cpu")
    assert res["correct"], res["checks"]


def test_a_pin_schedule_takes_effect_at_its_frame(tmp_path):
    root = tiny_root(tmp_path)
    cfg = strip_config(root)
    scene = build_scene(cfg, root)
    rec = cfg["recording"]
    args = (scene, rec["frames"], rec["iterations"], cfg["dt"],
            cfg["damping"], gravity(scene))
    held, _ = fom.record(*args)
    freed, _ = fom.record(*args, rec["events"])
    assert np.array_equal(held[:12], freed[:12])
    right = scene.sets["right"]
    assert np.abs(held[-1, right] - scene.positions[right]).max() < 1e-6
    assert np.abs(freed[-1, right] - scene.positions[right]).max() > 0.1
    with pytest.raises(ValueError, match="bad pin event"):
        fom.record(*args, [{"frame": 3, "action": "fix", "set": "middle"}])


def test_a_kind_with_padded_corners_runs_the_reference(tmp_path):
    root = tiny_root(tmp_path)
    (root / "portbench/reference/kinds/verts_star.py").write_text(STAR)
    cfg = strip_config(root)
    cfg["groups"] = {"edge_spring": {"wi": 1e4}, "verts_star": {"wi": 10.0}}
    cfg["bases"]["modes"] = {"edge_spring": 9, "verts_star": 12}
    cfg["served"]["modes"] = {"edge_spring": 6, "verts_star": 9}
    scene = build_scene(cfg, root)
    star = scene.groups["verts_star"]
    mask = star.data["mask"]
    assert star.num == scene.n and mask.sum(axis=1).min() < mask.shape[1]
    made = bases.make(cfg, root=root)
    shape = core.cost_shape(scene, cfg, made)
    data = np.load(f"{made['dir']}/verts_star/basis.npz")
    alphas = data["interpol_alphas"][:shape["rows"]["verts_star"]]
    real = np.where(star.data["mask"][alphas], star.data["star"][alphas, 1:],
                    -1)
    assert shape["rows"]["verts_star"] == 12
    ref = ReducedReference(scene, cfg, made["dir"], made["pos"])
    assert ref.n_sel == shape["n_sel"]
    assert set(np.unique(real[real >= 0])) <= set(ref.sel.tolist())
    # the reference's rows at the rest pose are the rest lengths
    pts = torch.as_tensor(scene.positions)[torch.as_tensor(
        star.data["star"])]
    rows = star.kind.rows(pts, fom.tensor_data(star.data, "cpu",
                                               torch.float64))
    assert torch.allclose(rows[:, 0].norm(dim=-1),
                          torch.as_tensor(star.data["rest"]))
    V0 = np.zeros_like(scene.positions)
    out = ref.rollout(scene.positions[None], V0[None],
                      gravity(scene)[None], 5)
    assert np.isfinite(out["P"]).all() and out["disp"][0] > 0
    assert shape["rows"] == {"edge_spring": 8, "verts_star": 12}
    assert call_cost(shape, 1, 5, root=root)[1] > 0
    # the roofline reader counts the kinds of the run's own checkout
    ctx = SimpleNamespace(root=root, shape=shape, trace={"busy_s": 1.0},
                          calls=2, sims=1, steps=5, clamp_share=0.0)
    assert core.metric_reader(root, "step_roofline.solo")(ctx) > 0


def test_no_shared_module_names_a_kind():
    kinds = {f.stem for d in ("kinds", "scenes")
             for f in (PB / "reference" / d).glob("*.py")}
    assert {"edge_spring", "cloth"} <= kinds
    pattern = re.compile(r"\b(%s)\b" % "|".join(sorted(
        kinds | set(PROGRAM_KINDS))))
    for f in SHARED:
        found = pattern.findall((PB / f).read_text())
        assert not found, (f, found)
