"""Constraint-group precompute: struct-of-arrays rest data, selection
(S^T) assembly triplets, and global-matrix (LHS) triplets per group.

Counterpart of ``animsnapbases_tpu/sim/groups.py``, kept as a copy so the
port imports nothing of the JAX package.

Each group g carries:
  * batched rest data used by its projection kernel (``projections.py``)
  * ``st_rows/st_cols/st_vals`` — COO triplets of the (N, e*p) assembly
    matrix S^T, so the rhs contribution is one gather + segment-sum
  * LHS triplets of  sum_i w_i S_i^T A_i^T A_i S_i  (3N x 3N)

Formulas mirror the reference constraints exactly (including its
weight-scaling conventions), see ``Constraint_projections.py``:
positional :77-113, bending :116-249, edge spring :274-333,
tri strain :353-455, tet strain :483-584, deformation gradient :627-827.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from animsnapbases_tpu_torch.geometry.mesh import build_vertex_stars

GROUP_NAMES = ("positional", "verts_bending", "edge_spring", "tris_strain",
               "tets_strain", "tets_deformation_gradient")

ROW_DIM = {"positional": 1, "verts_bending": 1, "edge_spring": 1,
           "tris_strain": 2, "tets_strain": 3,
           "tets_deformation_gradient": 3}


@dataclass
class ConstraintGroup:
    name: str
    p: int                       # rows per constraint
    num: int                     # e: number of constraints
    data: dict = field(default_factory=dict)      # batched rest data
    st_rows: np.ndarray | None = None             # COO of S^T (N, e*p)
    st_cols: np.ndarray | None = None
    st_vals: np.ndarray | None = None
    lhs_rows: np.ndarray | None = None            # COO of LHS term (3N, 3N)
    lhs_cols: np.ndarray | None = None
    lhs_vals: np.ndarray | None = None

    def assembly_scipy(self, n_verts: int):
        """S^T as scipy sparse (N, e*p) for export parity."""
        from scipy.sparse import csr_matrix

        return csr_matrix((self.st_vals, (self.st_rows, self.st_cols)),
                          shape=(n_verts, self.num * self.p))


# ---------------------------------------------------------------------------
# positional
# ---------------------------------------------------------------------------

def build_positional(indices, wi: float, positions: np.ndarray,
                     motion_types: list[str] | None = None,
                     frame_shifts: list | None = None) -> ConstraintGroup:
    indices = np.asarray(indices, dtype=np.int64)
    e = len(indices)
    g = ConstraintGroup("positional", 1, e)
    g.data = {
        "indices": indices,
        "p0": positions[indices].copy(),
        "wi": np.full(e, wi),
        "motion_types": list(motion_types) if motion_types else ["fixed"] * e,
        "frame_shifts": list(frame_shifts) if frame_shifts else [None] * e,
    }
    g.st_rows = indices.copy()
    g.st_cols = np.arange(e)
    g.st_vals = np.full(e, wi)
    # LHS: wi on the 3 diagonal entries of each constrained vertex
    base = 3 * np.repeat(indices, 3) + np.tile(np.arange(3), e)
    g.lhs_rows = base
    g.lhs_cols = base.copy()
    g.lhs_vals = np.full(3 * e, wi)
    return g


# ---------------------------------------------------------------------------
# vertex bending
# ---------------------------------------------------------------------------

def build_verts_bending(positions: np.ndarray, faces: np.ndarray, wi: float,
                        voronoi_area: np.ndarray,
                        prevent_bending_flips: bool = True,
                        flat_bending: bool = False) -> ConstraintGroup:
    """One constraint per interior vertex (all star edges have 2 triangles).
    Mirrors the reference cotan/star construction including its
    wi_eff = wi * voronoi_area scaling of both S and the LHS.

    Deliberate fix (README deviation #2): the reference's
    ``get_wi_SiT_AiT_Ai_Si`` computes ``K = S^T @ S`` with S shaped (N, 1)
    — a 1x1 scalar whose triplets land on vertex 0's diagonal only
    (Constraint_projections.py:223-249), so bending stiffness never enters
    its system matrix.  We assemble the intended outer product
    ``wi_eff * (S col)(S col)^T`` over the vertex star."""
    n = positions.shape[0]
    stars = build_vertex_stars(n, faces)

    centers = []
    nbr_list = []           # ragged neighbor ids per center
    cot_list = []           # matching cotan weights
    rest_curv = []
    tri_normals = []
    dot_normals = []
    wi_eff_list = []

    def angle(a, b, c):
        u = a - b
        v = c - b
        d = np.clip(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)),
                    -1, 1)
        return np.arccos(d)

    for v in range(n):
        star = stars[v]
        if not star or any(e.t2 < 0 for e in star):
            continue
        A = voronoi_area[v]
        p0 = positions[v]
        cots = []
        tris_seen = set()
        tri_ids = []
        for e_ in star:
            a1 = angle(p0, positions[e_.v_other_t1], positions[e_.v2])
            cot = 0.5 / np.tan(a1)
            if e_.t2 >= 0:
                a2 = angle(p0, positions[e_.v_other_t2], positions[e_.v2])
                cot += 0.5 / np.tan(a2)
            cots.append(cot / A)
            for t in (e_.t1, e_.t2):
                if t >= 0 and t not in tris_seen:
                    tris_seen.add(t)
                    tri_ids.append(t)
        cots = np.array(cots)
        nbrs = np.array([e_.v2 for e_ in star], dtype=np.int64)

        mean_curv = ((positions[v] - positions[nbrs]) * cots[:, None]).sum(axis=0)
        rest = 0.0 if flat_bending else float(np.linalg.norm(mean_curv))

        # average triangle normal for stability
        normals = []
        for t in tri_ids:
            a, b, c = positions[faces[t]]
            nvec = np.cross(b - a, c - a)
            ln = np.linalg.norm(nvec)
            if ln > 1e-10:
                normals.append(nvec / ln)
        tri_n = (np.mean(normals, axis=0) if normals
                 else np.array([0.0, 0.0, 1.0]))

        centers.append(v)
        nbr_list.append(nbrs)
        cot_list.append(cots)
        rest_curv.append(rest)
        tri_normals.append(tri_n)
        dot_normals.append(float(tri_n @ mean_curv))
        wi_eff_list.append(wi * A)

    e = len(centers)
    g = ConstraintGroup("verts_bending", 1, e)
    if e == 0:
        g.data = {"indices": np.empty(0, dtype=np.int64)}
        g.st_rows = g.st_cols = np.empty(0, dtype=np.int64)
        g.st_vals = np.empty(0)
        g.lhs_rows = g.lhs_cols = np.empty(0, dtype=np.int64)
        g.lhs_vals = np.empty(0)
        return g

    dmax = max(len(nb) for nb in nbr_list)
    nbrs_pad = np.zeros((e, dmax), dtype=np.int64)
    cots_pad = np.zeros((e, dmax))
    mask = np.zeros((e, dmax), dtype=bool)
    for i, (nb, ct) in enumerate(zip(nbr_list, cot_list)):
        nbrs_pad[i, :len(nb)] = nb
        cots_pad[i, :len(ct)] = ct
        mask[i, :len(nb)] = True

    centers = np.array(centers, dtype=np.int64)
    wi_eff = np.array(wi_eff_list)
    g.data = {
        "indices": centers,
        "neighbors": nbrs_pad,
        "cotans": cots_pad,
        "mask": mask,
        "rest_curvature": np.array(rest_curv),
        "tri_normal": np.array(tri_normals),
        "dot_with_normal": np.array(dot_normals),
        "wi_eff": wi_eff,
        "prevent_bending_flips": prevent_bending_flips,
    }

    # S column of constraint i: center gets sum(cotans)*wi_eff, neighbor j
    # gets -cotan_j*wi_eff  (ref :189-195)
    rows, cols, vals = [], [], []
    for i in range(e):
        c_sum = cots_pad[i, mask[i]].sum()
        rows.append(centers[i]); cols.append(i); vals.append(c_sum * wi_eff[i])
        for j in np.nonzero(mask[i])[0]:
            rows.append(nbrs_pad[i, j]); cols.append(i)
            vals.append(-cots_pad[i, j] * wi_eff[i])
    g.st_rows = np.array(rows, dtype=np.int64)
    g.st_cols = np.array(cols, dtype=np.int64)
    g.st_vals = np.array(vals)

    # LHS: K = wi_eff * (S S^T) over involved vertices, replicated on the
    # 3 diagonal dims (ref :223-248; note the extra wi_eff factor on top of
    # the wi_eff-scaled S — reference convention preserved)
    lr, lc, lv = [], [], []
    for i in range(e):
        involved = np.concatenate([[centers[i]], nbrs_pad[i, mask[i]]])
        svals = np.concatenate([[cots_pad[i, mask[i]].sum() * wi_eff[i]],
                                -cots_pad[i, mask[i]] * wi_eff[i]])
        K = wi_eff[i] * np.outer(svals, svals)
        for a in range(len(involved)):
            for b in range(len(involved)):
                if abs(K[a, b]) > 1e-12:
                    for d in range(3):
                        lr.append(3 * involved[a] + d)
                        lc.append(3 * involved[b] + d)
                        lv.append(K[a, b])
    g.lhs_rows = np.array(lr, dtype=np.int64)
    g.lhs_cols = np.array(lc, dtype=np.int64)
    g.lhs_vals = np.array(lv)
    return g


# ---------------------------------------------------------------------------
# edge spring
# ---------------------------------------------------------------------------

def build_edge_spring(edges: np.ndarray, wi: float,
                      positions: np.ndarray) -> ConstraintGroup:
    edges = np.asarray(edges, dtype=np.int64)
    e = len(edges)
    g = ConstraintGroup("edge_spring", 1, e)
    rest = np.linalg.norm(positions[edges[:, 0]] - positions[edges[:, 1]],
                          axis=1)
    g.data = {"edges": edges, "rest_length": rest, "wi": np.full(e, wi)}

    # S column: -wi at v0, +wi at v1 (ref :285-289)
    g.st_rows = edges.flatten()
    g.st_cols = np.repeat(np.arange(e), 2)
    g.st_vals = np.tile([-wi, wi], e)

    # LHS: w/2 on diagonals, -w/2 cross (ref :322-333)
    w = wi * 0.5
    lr, lc, lv = [], [], []
    v0, v1 = edges[:, 0], edges[:, 1]
    for d in range(3):
        lr += [3 * v0 + d, 3 * v1 + d, 3 * v0 + d, 3 * v1 + d]
        lc += [3 * v0 + d, 3 * v1 + d, 3 * v1 + d, 3 * v0 + d]
        lv += [np.full(e, w), np.full(e, w), np.full(e, -w), np.full(e, -w)]
    g.lhs_rows = np.concatenate(lr)
    g.lhs_cols = np.concatenate(lc)
    g.lhs_vals = np.concatenate(lv)
    return g


# ---------------------------------------------------------------------------
# triangle strain
# ---------------------------------------------------------------------------

def build_tris_strain(faces: np.ndarray, wi: float, positions: np.ndarray,
                      sigma_min: float, sigma_max: float) -> ConstraintGroup:
    faces = np.asarray(faces, dtype=np.int64)
    e = len(faces)
    g = ConstraintGroup("tris_strain", 2, e)

    p1 = positions[faces[:, 0]]
    p2 = positions[faces[:, 1]]
    p3 = positions[faces[:, 2]]
    e1 = p2 - p1
    e2 = p3 - p1
    # local 2D tangent basis P (e, 3, 2)
    b0 = e1 / np.linalg.norm(e1, axis=1, keepdims=True)
    b1 = e2 - (e2 * b0).sum(axis=1, keepdims=True) * b0
    b1 = b1 / np.linalg.norm(b1, axis=1, keepdims=True)
    P = np.stack([b0, b1], axis=2)

    rest_edges = np.stack([e1, e2], axis=2)                 # (e, 3, 2)
    rest2d = np.einsum("eij,eik->ejk", P, rest_edges)        # (e, 2, 2)
    DmInv = np.linalg.inv(rest2d)
    A0 = 0.5 * np.linalg.det(rest2d)
    scale = wi * np.abs(A0)

    g.data = {"faces": faces, "P": P, "DmInv": DmInv, "A0": A0,
              "scale": scale, "sigma_min": sigma_min, "sigma_max": sigma_max}

    # Deformation-gradient operator B (e, 3 verts, 2 cols):
    # since Ds = [q2-q1, q3-q1], dF/dq2 = DmInv row 0, dF/dq3 = DmInv row 1,
    # dF/dq1 = -(row0 + row1).
    #
    # DELIBERATE FIX of a reference bug (Constraint_projections.py:388-405):
    # the reference maps v1<-row0, v2<-row1, v3<- -sum — off by one vertex —
    # and builds the LHS from DmInv *columns* (:431-444), so its tri-strain
    # rest state is not an equilibrium (drifts at high wi).  With the correct
    # shared operator, rest satisfies B^T q = P exactly and the constraint is
    # stable at any weight.
    B = np.empty((e, 3, 2))
    B[:, 1, :] = DmInv[:, 0, :]
    B[:, 2, :] = DmInv[:, 1, :]
    B[:, 0, :] = -(DmInv[:, 0, :] + DmInv[:, 1, :])

    st_rows, st_cols, st_vals = [], [], []
    for j in range(3):
        for c in range(2):
            st_rows.append(faces[:, j])
            st_cols.append(np.arange(e) * 2 + c)
            st_vals.append(B[:, j, c] * scale)
    g.st_rows = np.concatenate(st_rows)
    g.st_cols = np.concatenate(st_cols)
    g.st_vals = np.concatenate(st_vals)

    # LHS: K = (B B^T) ⊗ I3 * wi*|A0| — same operator both sides
    K33 = np.einsum("eac,ebc->eab", B, B)                     # (e, 3, 3)
    lr, lc, lv = [], [], []
    for a in range(3):
        for b in range(3):
            for d in range(3):
                lr.append(3 * faces[:, a] + d)
                lc.append(3 * faces[:, b] + d)
                lv.append(K33[:, a, b] * scale)
    g.lhs_rows = np.concatenate(lr)
    g.lhs_cols = np.concatenate(lc)
    g.lhs_vals = np.concatenate(lv)
    return g


# ---------------------------------------------------------------------------
# tet strain / deformation gradient (shared rest data)
# ---------------------------------------------------------------------------

def _tet_rest(elements: np.ndarray, positions: np.ndarray):
    p = positions[elements]                                   # (e, 4, 3)
    Dm = np.stack([p[:, 0] - p[:, 3], p[:, 1] - p[:, 3],
                   p[:, 2] - p[:, 3]], axis=2)                # (e, 3, 3)
    DmInv = np.linalg.inv(Dm)
    V0 = np.linalg.det(Dm) / 6.0
    return DmInv, V0


def _tet_group(name: str, elements: np.ndarray, wi: float,
               positions: np.ndarray, extra: dict) -> ConstraintGroup:
    elements = np.asarray(elements, dtype=np.int64)
    e = len(elements)
    g = ConstraintGroup(name, 3, e)
    DmInv, V0 = _tet_rest(elements, positions)
    scale = wi * np.abs(V0)
    g.data = {"elements": elements, "DmInv": DmInv, "V0": V0, "scale": scale}
    g.data.update(extra)

    # S columns (ref :510-532): G = [DmInv^T | -rowsum] (3, 4); vertex j gets
    # G[:, j] * wi*|V0|; column j<3 of G is DmInv row j
    st_rows, st_cols, st_vals = [], [], []
    Grows = np.concatenate([DmInv, -DmInv.sum(axis=1, keepdims=True)],
                           axis=1)                            # (e, 4, 3)
    for j in range(4):
        for c in range(3):
            st_rows.append(elements[:, j])
            st_cols.append(np.arange(e) * 3 + c)
            st_vals.append(Grows[:, j, c] * scale)
    g.st_rows = np.concatenate(st_rows)
    g.st_cols = np.concatenate(st_cols)
    g.st_vals = np.concatenate(st_vals)

    # LHS (ref :559-584): G rows = DmInv rows + (-rowsum); K = G G^T
    K44 = np.einsum("eic,ejc->eij", Grows, Grows)             # (e, 4, 4)
    lr, lc, lv = [], [], []
    for a in range(4):
        for b in range(4):
            for d in range(3):
                lr.append(3 * elements[:, a] + d)
                lc.append(3 * elements[:, b] + d)
                lv.append(K44[:, a, b] * scale)
    g.lhs_rows = np.concatenate(lr)
    g.lhs_cols = np.concatenate(lc)
    g.lhs_vals = np.concatenate(lv)
    return g


def build_tets_strain(elements, wi, positions, sigma_min, sigma_max):
    return _tet_group("tets_strain", elements, wi, positions,
                      {"sigma_min": sigma_min, "sigma_max": sigma_max})


def build_tets_deformation_gradient(elements, wi, positions):
    return _tet_group("tets_deformation_gradient", elements, wi, positions, {})
