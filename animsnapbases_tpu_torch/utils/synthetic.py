"""Synthetic-basis reduced-solver factory for smokes and tests.

Counterpart of ``animsnapbases_tpu/utils/synthetic.py``: the same seed,
the same numpy draws in the same order and the same product ``.npz``
schema, so that both packages read identical bases; beside it, block-form
bases (``deim_pca_blocks``: all p rows of each selected element) and
oversampled DEIM (more interpolation rows than modes).  The accuracy of the
bases is irrelevant; the code paths and the shapes are what count.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def synthetic_reduced_solver(model, K: int = 6, r: int = 8,
                             extra_args: dict | None = None,
                             device=None, dtype=None, matmul_dtype=None,
                             work_dir: str | None = None,
                             block: bool = False, oversample: float = 1.0,
                             components: dict | None = None):
    """Returns a prepared fully-reduced solver for ``model``.

    Every non-positional group gets a random basis of K modes (or
    ``components[name]``): in row form (``deim_pod_vectorized``) a
    (K, e*p, 3) basis with random DEIM rows, in block form (``block``,
    ``deim_pca_blocks``) a (K*p, e*p, 3) basis with random selected
    elements.  ``oversample`` > 1 draws ``round(K * oversample)``
    interpolation rows (or elements) and sets ``deim_oversample``, so that
    the solver takes them all (least-squares DEIM).  With the defaults the
    draws are the JAX package's.  The position basis is per-dim
    orthonormal (r modes).  ``extra_args`` overrides sim-arg fields after
    the reduction flags are set.  The bases are written under ``work_dir``
    (a new temporary directory when None)."""
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
    args.constraint_projection_basis_type = ("deim_pca_blocks" if block
                                             else "deim_pod_vectorized")
    args.deim_oversample = oversample
    for name, g in model.groups.items():
        if name == "positional":
            continue
        k = (components or {}).get(name, K)
        rows = int(round(k * oversample))
        ep = g.num * g.p
        if block:
            comps = rng.normal(size=(k * g.p, ep, 3)) / np.sqrt(ep)
            alphas = np.sort(rng.choice(g.num, size=rows, replace=False))
            Pt = (alphas[:, None] * g.p + np.arange(g.p)).reshape(-1)
        else:
            comps = rng.normal(size=(k, ep, 3)) / np.sqrt(ep)
            Pt = np.sort(rng.choice(ep, size=rows, replace=False))
            alphas = Pt // g.p
        gdir = os.path.join(basis_dir, name)
        os.makedirs(gdir, exist_ok=True)
        np.savez(os.path.join(gdir, "basis.npz"), components=comps,
                 interpol_alphas=alphas, Pt=Pt,
                 interpol_verts=np.array([]),
                 interpol_alpha_ranges=np.arange(1, rows + 1))
        flag, num = GROUP_ARG_NAMES[name]
        setattr(args, flag, True)
        setattr(args, num, k)
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
