"""The scene of a configuration as plain arrays, and its constraint groups.

What a configuration's scene and groups are made of is found by name, as
``core.metric_reader`` finds a metric:

* ``portbench/reference/scenes/<scene kind>.py``: ``build(spec)`` ->
  (V (N, 3), F (F, 3), T (T, 4) or None, pinned (N,) bool), the vertices,
  faces, tets and the scene's own pins of the configuration's ``scene``;
* ``portbench/reference/kinds/<constraint kind>.py``, one a group of
  ``groups``: ``p``, the rows an element has; ``build(V, F, T, group)`` ->
  (rest data, S^T (N, e p), the group's (N, N) block of each dimension's
  global matrix); ``corners(data)``, the (e, c) vertex ids of each element
  (padded columns repeat a corner of their own element, and a mask in the
  rest data leaves them out); ``rows(corners, data)``, the projection in
  plain PyTorch over any leading axes, (..., m, c, 3) -> (..., m, p, 3);
  ``PROGRAM``, the program's side as data (``method``: the
  ``DeformableModel`` method that adds the group, ``kwargs``: the keys of
  the group's entry it takes, ``group``: the program's group name, its
  ``GROUP_ARG_NAMES`` key); ``ROW_FLOPS``, the operations of one row on
  the card.  A kind's file is named as the program names its group: the
  bases of a group are written to, and read by the program from, the
  folder of that name.

A scene's ``pins`` rule, where given, replaces the scene's own pins by the
upstream's side sets (``animsnapbases_tpu_torch/sim/model.py``
``compute_cloth_corner_indices`` at commit
694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3: the surface vertices within
0.01 of the x and y extents, its fixed ``threshold_fixing_ratio``):
``{"sides": [...]}``.  The side sets are also the sets a recording's pin
schedule names.

Nothing here imports the program or the JAX package.
"""

from __future__ import annotations

import importlib.util
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import numpy as np
import scipy.sparse

ROOT = Path(__file__).resolve().parents[2]
FLOOR_HEIGHT = 0.0
PIN_MASS = 1e10
SIDE_RATIO = 0.01
SIDES = ("left", "right", "bottom", "top")


def part_path(folder: str, name: str, root=None) -> Path:
    """``portbench/reference/<folder>/<name>.py`` of the checkout at
    ``root`` (default: the one this module is in); a missing file raises
    an error that names it."""
    if not re.fullmatch(r"\w+", str(name)):
        raise ValueError(f"portbench: bad {folder} name {name!r}")
    path = (Path(root or ROOT) / "portbench" / "reference" / folder
            / f"{name}.py")
    if not path.exists():
        raise FileNotFoundError(
            f"portbench: no {folder} file for {name!r}: {path} is missing")
    return path


def load_part(folder: str, name: str, root=None) -> ModuleType:
    """The module of ``part_path``."""
    path = part_path(folder, name, root)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(name: str, root=None) -> ModuleType:
    """The constraint kind ``name``."""
    return load_part("kinds", name, root)


def per_group(value, group: str) -> int:
    """A width given as one number for every group, or as a ``{group:
    number}`` map."""
    if isinstance(value, dict):
        if group not in value:
            raise KeyError(f"portbench: no width for group {group!r} in "
                           f"{value!r}")
        value = value[group]
    return int(value)


def coo(rows, cols, vals, shape) -> scipy.sparse.csr_matrix:
    """The csr matrix of the concatenated triplets."""
    return scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=shape).tocsr()


@dataclass
class Group:
    """One constraint group: ``p`` rows an element, ``num`` elements, the
    rest data its projection reads, ``ST`` (N, num * p) and ``block`` the
    group's (N, N) share of each dimension's global matrix; ``kind`` its
    kind's module."""
    name: str
    p: int
    num: int
    data: dict
    ST: scipy.sparse.csr_matrix
    block: scipy.sparse.csr_matrix
    kind: ModuleType


@dataclass
class Scene:
    positions: np.ndarray          # (N, 3) initial positions
    faces: np.ndarray              # (F, 3)
    tets: np.ndarray | None        # (T, 4) or None
    mass: np.ndarray               # (N,) nominal masses
    pinned: np.ndarray             # (N,) bool
    floor: bool
    groups: dict = field(default_factory=dict)
    sets: dict = field(default_factory=dict)   # side -> vertex ids

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    @property
    def masses(self) -> np.ndarray:
        """The masses the solve sees: pinned vertices at PIN_MASS."""
        return pin_masses(self.mass, self.pinned)


def pin_masses(mass: np.ndarray, pinned: np.ndarray) -> np.ndarray:
    m = mass.copy()
    m[pinned] = PIN_MASS
    return m


def side_sets(V: np.ndarray, F: np.ndarray) -> dict:
    """The surface vertices within ``SIDE_RATIO`` of the x and y extents,
    per side."""
    x, y = V[:, 0], V[:, 1]
    xt = SIDE_RATIO * (x.max() - x.min())
    yt = SIDE_RATIO * (y.max() - y.min())
    surface = np.unique(F.reshape(-1)) if F.size else np.arange(len(V))
    masks = (x <= x.min() + xt, x >= x.max() - xt, y <= y.min() + yt,
             y >= y.max() - yt)
    return {s: np.intersect1d(np.flatnonzero(m), surface)
            for s, m in zip(SIDES, masks)}


def build_scene(cfg: dict, root=None) -> Scene:
    """The scene of configuration ``cfg`` (its ``scene`` and ``groups``),
    its kinds read from the checkout at ``root``."""
    spec = cfg["scene"]
    V, F, T, pinned = load_part("scenes", spec["kind"], root).build(spec)
    rule = spec.get("pins")
    sets = side_sets(V, F)
    if rule is not None:
        pinned = np.zeros(len(V), dtype=bool)
        for side in rule["sides"]:
            pinned[sets[side]] = True
    scene = Scene(positions=V, faces=F, tets=T,
                  mass=np.full(len(V), float(spec["mass"])), pinned=pinned,
                  floor=bool(spec["floor"]), sets=sets)
    for name, g in cfg["groups"].items():
        kind = kind_module(name, root)
        data, ST, block = kind.build(V, F, T, g)
        scene.groups[name] = Group(name, kind.p, ST.shape[1] // kind.p,
                                   data, ST, block, kind)
    return scene


def global_block(scene: Scene, dt: float,
                 masses: np.ndarray | None = None) -> scipy.sparse.csc_matrix:
    """One dimension's (N, N) global matrix: M / dt^2 + the groups'
    blocks (every group couples equal dimensions only, alike in each);
    ``masses`` default to the scene's."""
    m = scene.masses if masses is None else masses
    A = scipy.sparse.diags(m / (dt * dt))
    for g in scene.groups.values():
        A = A + g.block
    return A.tocsc()


def gravity(scene: Scene) -> np.ndarray:
    """-9.81 x the nominal mass along y on every vertex."""
    f = np.zeros_like(scene.positions)
    f[:, 1] = -9.81 * scene.mass
    return f
