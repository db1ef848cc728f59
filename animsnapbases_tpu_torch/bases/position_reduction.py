"""Position-space bases of the reduced solver.

Counterpart of ``animsnapbases_tpu/bases/position_reduction.py``: a
per-dimension snapshot POD of the raw positions (no mean subtracted, so
that the rest and affine content lie in the span), orthonormal per
dimension, on the port's device in float64.
"""

from __future__ import annotations

import numpy as np

from animsnapbases_tpu_torch.ops.podlinalg import snapshot_pod


def position_basis_from_trajectory(traj: np.ndarray, r: int,
                                   device=None) -> np.ndarray:
    """traj (F, N, 3) -> components (r, N, 3), orthonormal per dimension,
    r clipped to the number of frames.  Where the trajectory has fewer
    than r independent frames, the zero columns are replaced by an
    orthonormal completion (QR of the columns plus a 1e-12 perturbation
    drawn from ``default_rng(0)``, as the JAX package draws it)."""
    F, N, _ = traj.shape
    r = min(r, F)
    comps = np.empty((r, N, 3))
    for d in range(3):
        U, s, _ = snapshot_pod(traj[:, :, d].T, device=device)
        Ud = U[:, :r].cpu().numpy()
        s = s.cpu().numpy()
        if s[r - 1] <= 1e-12 * (float(s[0]) + 1e-30):
            Ud, _ = np.linalg.qr(Ud + 1e-12 * np.random.default_rng(0)
                                 .standard_normal(Ud.shape))
        comps[:, :, d] = Ud.T
    return comps


def save_position_basis(path: str, comps: np.ndarray) -> None:
    np.savez(path, components=comps)
