"""``edge_spring``: each edge held at its rest length.

Frozen copies, made at commit 694e46ca6bbdc322cf66d9b3fd65d3e4c5b05da3,
of ``animsnapbases_tpu_torch/geometry/mesh.py`` ``unique_edges`` and
``tet_edges`` (the same edge order, so that the element indices of the
bases name the same edges in the program's model), ``sim/groups.py``
``build_edge_spring`` (reduced to the rest lengths, S^T and the block) and
``sim/projections.py`` ``edge_spring_p``: half the edge vector shortened to
half its rest length.  The edges are the tets' where the scene has tets,
else the faces'.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.scene import coo

p = 1
# the spring row: csrc/iteration.cuh:218-229 (KIND_SPRING), counted in
# chip_smoke.py:300-311
ROW_FLOPS = 20
PROGRAM = {"method": "add_edge_spring_constraint", "kwargs": ["wi"],
           "group": "edge_spring"}


def unique_edges(faces: np.ndarray) -> np.ndarray:
    faces = np.asarray(faces, dtype=np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    return np.unique(np.sort(e, axis=1), axis=0)


def tet_edges(tets: np.ndarray) -> np.ndarray:
    tets = np.asarray(tets, dtype=np.int64)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    e = np.concatenate([tets[:, list(q)] for q in pairs])
    return np.unique(np.sort(e, axis=1), axis=0)


def build(V, F, T, group):
    edges = tet_edges(T) if T is not None else unique_edges(F)
    wi = group["wi"]
    e, n = len(edges), len(V)
    rest = np.linalg.norm(V[edges[:, 0]] - V[edges[:, 1]], axis=1)
    v0, v1 = edges[:, 0], edges[:, 1]
    w = np.full(e, 0.5 * wi)
    ST = coo((v0, v1), (np.arange(e), np.arange(e)),
             (np.full(e, -wi), np.full(e, wi)), (n, e))
    blk = coo((v0, v1, v0, v1), (v0, v1, v1, v0), (w, w, -w, -w), (n, n))
    return {"edges": edges, "rest_length": rest}, ST, blk


def corners(data):
    return data["edges"]


def rows(corners, data):
    spring = corners[..., 1, :] - corners[..., 0, :]
    length = torch.linalg.vector_norm(spring, dim=-1, keepdim=True)
    safe = torch.where(length > 0, length, torch.ones_like(length))
    rest = data["rest_length"][..., None]
    p = 0.5 * spring - 0.5 * (length - rest) * spring / safe
    return torch.where(length > 0, p, torch.zeros_like(p))[..., None, :]
