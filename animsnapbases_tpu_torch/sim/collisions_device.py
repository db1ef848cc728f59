"""Self-collision on the state's device: the masked O(n*k) pass.

Counterpart of ``animsnapbases_tpu/sim/collisions_device.py``, in plain
torch on whatever device the positions lie on.  For every vertex the k
nearest triangle centroids are found (squared distances by the identity
|q|^2 + |c|^2 - 2 q.c, ``topk`` per row), each candidate triangle is
tested with a branchless closest point on the triangle, and every pushout
correction accumulates at once: the math of the host
``collisions.resolve_self_collision_fast``, which accumulates into a copy,
so the two agree up to ties among the candidates.

The serving tier of the reduced solver (``sim/reduced.py``
``_run_steps_self_collision``) certifies windows in which the pass is the
identity; its certificate rests on the pass and the exact clearance probe
testing the same candidates with the same metric, so both go through
:func:`_candidate_distances`.
"""

from __future__ import annotations

import torch

# the pair budget of one slab of the (n, m) centroid-distance matrix:
# above it the candidates (and the bound's minimum) are computed in row
# slabs of at most this many pairs, which gives the same rows, since topk
# and the minima are row-independent.  2^28 pairs is a 1 GiB float32 slab;
# with the three or four slab-sized temporaries that the distances and
# topk keep alive, under 5 % of an H100's 80 GB, so a 25,600-vertex cloth
# (1.29e9 pairs) takes five slabs beside the solver's own operands.
MAX_PAIRS = 1 << 28
# candidate triangles per vertex
K_NEAREST = 5
# the pass's distance: a vertex closer than this to a non-own candidate
# triangle is pushed out.  One constant for the pass and for the reduced
# solver's serving tier, whose certificate (the pass is the identity while
# the probed clearance is at least this) needs both to read one value.
MIN_DIST = 0.001


def _safe_div(num, den):
    """num / den with |den| <= 1e-30 replaced by 1, so that a region the
    selection drops injects no NaN or inf."""
    return num / torch.where(torch.abs(den) > 1e-30, den,
                             torch.ones_like(den))


def _dot(x, y):
    return (x * y).sum(dim=-1)


def closest_point_on_triangle(p, a, b, c):
    """Branchless Ericson closest point of p on the triangle (a, b, c),
    elementwise over leading axes: (..., 3) each -> (..., 3).  The regions
    are those of the host ``_point_triangle_closest``, in its order of
    precedence; every region's point is computed with guarded divisions
    and the selection picks one."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    p_ab = a + _safe_div(d1, d1 - d3)[..., None] * ab
    p_ac = a + _safe_div(d2, d2 - d6)[..., None] * ac
    p_bc = b + _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))[..., None] * (c - b)
    denom = _safe_div(torch.ones_like(va), va + vb + vc)
    p_face = a + ab * (vb * denom)[..., None] + ac * (vc * denom)[..., None]

    r1 = (d1 <= 0) & (d2 <= 0)
    r2 = (d3 >= 0) & (d4 <= d3)
    r3 = (d6 >= 0) & (d5 <= d6)
    r4 = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    r5 = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    r6 = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    out = p_face
    out = torch.where(r6[..., None], p_bc, out)
    out = torch.where(r5[..., None], p_ac, out)
    out = torch.where(r4[..., None], p_ab, out)
    out = torch.where(r3[..., None], c, out)
    out = torch.where(r2[..., None], b, out)
    out = torch.where(r1[..., None], a, out)
    return out


def _block_rows(n: int, m: int, max_pairs: int) -> int:
    """Rows of a slab of at most ``max_pairs`` pairs (at least one)."""
    return max(1, min(n, max_pairs // max(m, 1)))


def _centroids(q, faces):
    """Triangle centroids (m, 3) and their squared norms (1, m)."""
    cent = q[faces].mean(dim=1)
    return cent, (cent * cent).sum(dim=1)[None, :]


def _sq_dists(qi, cent, cc):
    """Squared vertex-centroid distances of the rows qi (rows, m), by the
    identity |q|^2 + |c|^2 - 2 q.c.  The (rows, 3) x (3, m) product is
    written out over the three coordinates: a matmul's rounding can depend
    on the number of rows (a one-row slab takes a matrix-vector product),
    and the slabs must give the rows of the single slab."""
    dot = qi[:, 0:1] * cent[:, 0]
    dot.addcmul_(qi[:, 1:2], cent[:, 1])
    dot.addcmul_(qi[:, 2:3], cent[:, 2])
    return ((qi * qi).sum(dim=1)[:, None] + cc).sub_(dot, alpha=2.0)


def _row_slabs(n: int, m: int, max_pairs: int):
    """(start, stop) of the row slabs: one slab when n*m fits the
    budget."""
    rows = n if n * m <= max_pairs else _block_rows(n, m, max_pairs)
    return [(s, min(s + rows, n)) for s in range(0, n, rows)]


def candidates(q, faces, k: int = K_NEAREST, max_pairs: int = MAX_PAIRS):
    """Indices (n, k) of the k triangles whose centroids are nearest to
    each vertex, nearest first (``topk`` per row, in slabs)."""
    n, m = q.shape[0], faces.shape[0]
    k = min(k, m)
    cent, cc = _centroids(q, faces)
    return torch.cat([
        torch.topk(-_sq_dists(q[s:e], cent, cc), k, dim=1).indices
        for s, e in _row_slabs(n, m, max_pairs)])


def _candidate_distances(q, faces, k: int, max_pairs: int):
    """The candidate pipeline that the pass and the exact probe share: the
    k nearest-centroid triangles of each vertex and the exact
    closest-point distances to them -> ``(idx (n, k), delta (n, k, 3), d
    (n, k), own (n, k))``, ``idx`` the candidate triangles nearest first,
    ``own`` marking the vertex's own triangles.

    Both :func:`resolve_self_collision_device` and
    :func:`min_clearance_device` MUST go through here: the serving tier's
    certificate (the pass is the identity exactly when the probed
    clearance is at least :data:`MIN_DIST`) holds only while the two test
    the same candidates with the same metric."""
    n = q.shape[0]
    idx = candidates(q, faces, k, max_pairs)
    cand = faces[idx]                                           # (n, k, 3)
    own = (cand == torch.arange(n, device=q.device)[:, None, None]).any(-1)
    tri = q[cand]                                               # (n, k, 3, 3)
    closest = closest_point_on_triangle(
        q[:, None, :], tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
    delta = q[:, None, :] - closest
    d = torch.linalg.vector_norm(delta, dim=-1)
    return idx, delta, d, own


def _push(q, delta, d, own, min_dist: float, stiffness: float):
    """The pass from the candidates' distances: each vertex pushed out of
    every non-own candidate closer than ``min_dist``, the corrections
    summed."""
    push = (~own) & (d > 1e-8) & (d < min_dist)
    scale = stiffness * (min_dist - d) / torch.clamp(d, min=1e-12)
    corr = scale[..., None] * delta * push[..., None]
    return q + corr.sum(dim=1)


def resolve_self_collision_device(q, faces, min_dist: float = MIN_DIST,
                                  stiffness: float = 1.0, k: int = K_NEAREST,
                                  max_pairs: int = MAX_PAIRS):
    """Vertex-vs-nearest-triangles pushout on q's device: q (n, 3) float,
    faces (m, 3) int64 on the same device -> the corrected positions."""
    _, delta, d, own = _candidate_distances(q, faces, k, max_pairs)
    return _push(q, delta, d, own, min_dist, stiffness)


def min_clearance_lower_bound_device(q, faces, max_pairs: int = MAX_PAIRS):
    """The cheap conservative clearance: the minimum over the vertices and
    their non-own triangles of ``|p - centroid| - R``, R the triangle's
    largest corner distance from its centroid.  Every point of a triangle
    lies within R of its centroid, so this is at most the exact
    point-triangle distance of every pair, hence at most
    :func:`min_clearance_device` (bound <= probe, the direction the serving
    tier needs).  One distance pass and a minimum per slab: no topk."""
    n, m = q.shape[0], faces.shape[0]
    tri = q[faces]
    cent, cc = _centroids(q, faces)
    R = torch.sqrt(((tri - cent[:, None, :]) ** 2).sum(dim=-1)).max(dim=1) \
        .values                                                 # (m,)
    face_ids = torch.arange(m, device=q.device)[:, None].expand(m, 3)
    best = None
    for s, e in _row_slabs(n, m, max_pairs):
        d = torch.sqrt(torch.clamp(_sq_dists(q[s:e], cent, cc), min=0.0))
        gap = d - R[None, :]
        # a vertex's own triangles: (vertex, face) pairs from the corners
        mine = (faces >= s) & (faces < e)
        gap[faces[mine] - s, face_ids[mine]] = torch.inf
        low = gap.min()
        best = low if best is None else torch.minimum(best, low)
    return best


def min_clearance_device(q, faces, k: int = K_NEAREST,
                         max_pairs: int = MAX_PAIRS):
    """The minimum vertex-to-nearest-non-own-triangle distance over the
    candidates the pass tests (:func:`_candidate_distances`).  The pass is
    identity exactly when this clearance is at least :data:`MIN_DIST`."""
    _, _, d, own = _candidate_distances(q, faces, k, max_pairs)
    return clearances(d, own).min()


def clearances(d, own):
    """Each vertex's distance to its nearest non-own candidate (n,) from
    :func:`_candidate_distances` (inf where every candidate is its
    own)."""
    return torch.where(own, torch.full_like(d, torch.inf), d).min(dim=1) \
        .values


def make_collide(faces, device):
    """``q -> resolved q`` over a fixed face array, its index tensor made
    once on ``device``.  The solvers cache it keyed on the faces and drop
    it when the model changes (stale faces push against the wrong
    triangles)."""
    faces_t = torch.as_tensor(faces, dtype=torch.int64, device=device)

    def collide(q):
        return resolve_self_collision_device(q, faces_t)

    collide.faces = faces_t
    return collide
