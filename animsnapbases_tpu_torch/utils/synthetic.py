"""Synthetic-basis reduced-solver factory for smokes and tests.

Counterpart of ``animsnapbases_tpu/utils/synthetic.py``: the same seed,
the same numpy draws in the same order and the same product ``.npz``
schema, so that both packages read identical bases.  The accuracy of the
bases is irrelevant; the code paths and the shapes are what count.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def synthetic_reduced_solver(model, K: int = 6, r: int = 8,
                             extra_args: dict | None = None,
                             device=None, dtype=None, matmul_dtype=None,
                             work_dir: str | None = None):
    """Returns a prepared fully-reduced solver for ``model``.

    Every non-positional group gets a (K, e*p, 3) random basis with K
    random DEIM rows; the position basis is per-dim orthonormal (r modes).
    ``extra_args`` overrides sim-arg fields after the reduction flags are
    set.  The bases are written under ``work_dir`` (a new temporary
    directory when None)."""
    from animsnapbases_tpu_torch.config.sim_config import default_sim_args
    from animsnapbases_tpu_torch.sim.reduced import (
        AnimSnapBasesSolver,
        GROUP_ARG_NAMES,
    )

    rng = np.random.default_rng(0)
    tmp = work_dir if work_dir is not None else tempfile.mkdtemp()
    basis_dir = os.path.join(tmp, "bases")
    args = default_sim_args()
    args.dt = 0.016
    args.constraint_projection_basis_type = "deim_pod_vectorized"
    for name, g in model.groups.items():
        if name == "positional":
            continue
        ep = g.num * g.p
        comps = rng.normal(size=(K, ep, 3)) / np.sqrt(ep)
        Pt = np.sort(rng.choice(ep, size=K, replace=False))
        gdir = os.path.join(basis_dir, name)
        os.makedirs(gdir, exist_ok=True)
        np.savez(os.path.join(gdir, "basis.npz"), components=comps,
                 interpol_alphas=Pt // g.p, Pt=Pt,
                 interpol_verts=np.array([]),
                 interpol_alpha_ranges=np.arange(1, K + 1))
        flag, num = GROUP_ARG_NAMES[name]
        setattr(args, flag, True)
        setattr(args, num, K)
    n = model.n_verts
    comps = np.empty((r, n, 3))
    for d in range(3):
        Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
        comps[:, :, d] = Q.T
    pos_path = os.path.join(tmp, "pos_basis.npz")
    np.savez(pos_path, components=comps)
    args.geom_interpolation_basis_dir = basis_dir
    args.geom_interpolation_basis_file = "basis.npz"
    args.position_reduced = True
    args.position_num_components = r
    args.position_basis_file = pos_path
    for k, v in (extra_args or {}).items():
        setattr(args, k, v)

    solver = AnimSnapBasesSolver(args, device=device, dtype=dtype,
                                 matmul_dtype=matmul_dtype)
    solver.set_model(model)
    solver.prepare(args)
    return solver
