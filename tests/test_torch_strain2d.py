"""The port's closed-form 2x2 clamp (``animsnapbases_tpu_torch.ops.strain2d``,
also carried by the CUDA kernels) against numpy's SVD and against the JAX
package's ``clamped_fhat_2x2``.

The port takes the half angle and the hypotenuses in forms that do not
cancel (see the module docstring); in float64 it agrees with the JAX
formula to rounding, and in float32 it stays accurate near F ~ I where
the JAX formula's half angle cancels (ROADMAP Queue C)."""

import numpy as np
import pytest
import torch

from animsnapbases_tpu.ops.strain2d import clamped_fhat_2x2 as jax_clamp
from animsnapbases_tpu_torch.ops.strain2d import clamped_fhat_2x2

SMIN, SMAX = 0.6, 1.4


def _fields(seed, near=True):
    """Random F, a third near I (1e-3), and with ``near`` a fifth very near
    I (1e-7), where the JAX half angle loses digits even in float64."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(128, 2, 2))
    F[::3] = np.eye(2) + 1e-3 * rng.normal(size=(len(F[::3]), 2, 2))
    if near:
        F[1::5] = np.eye(2) + 1e-7 * rng.normal(size=(len(F[1::5]), 2, 2))
    F[::7, :, 0] *= -1
    return F


def _near_pi():
    """F ~ I with F00 < F11 and a tiny shear: the rotation angle a1 of
    (Fv, G) is ~pi, where sqrt((1 + cos a1)/2) cancels."""
    F = np.tile(np.eye(2), (6, 1, 1))
    F[:, 1, 1] += np.array([1e-6, 2e-6, 5e-6, 1e-5, 3e-6, 4e-6])
    F[:, 0, 1] = np.array([1e-9, -2e-9, 5e-10, 1e-8, -3e-9, 2e-10])
    return F


def _svd_clamp(F):
    out = np.empty_like(F)
    for i in range(len(F)):
        U, s, Vt = np.linalg.svd(F[i])
        out[i] = U @ np.diag(np.clip(s, SMIN, SMAX)) @ Vt
    return out


def _port(F, dtype):
    t = [torch.tensor(F[:, i, j], dtype=dtype) for i in (0, 1)
         for j in (0, 1)]
    f = clamped_fhat_2x2(*t, SMIN, SMAX)
    return np.stack([np.stack([f[0], f[1]], -1),
                     np.stack([f[2], f[3]], -1)], 1).astype(np.float64)


@pytest.mark.parametrize("seed", range(3))
def test_matches_svd_float64(seed):
    F = np.concatenate([_fields(seed), _near_pi()])
    np.testing.assert_allclose(_port(F, torch.float64), _svd_clamp(F),
                               rtol=0, atol=1e-9)


def _jax(F):
    f = jax_clamp(F[:, 0, 0], F[:, 0, 1], F[:, 1, 0], F[:, 1, 1], SMIN, SMAX)
    return np.stack([np.asarray(x) for x in f], -1).reshape(-1, 2, 2)


@pytest.mark.parametrize("seed", range(3))
def test_matches_jax_float64(seed):
    """Same function as the JAX formula.  The tolerance is the JAX
    formula's own distance from the SVD on these fields (measured up to
    1.3e-9, at near-reflections F ~ diag(-1, 1) where its half angle
    cancels); the port's is 2.2e-16 there."""
    F = _fields(seed, near=False)
    np.testing.assert_allclose(_port(F, torch.float64), _jax(F), rtol=0,
                               atol=1e-8)


def test_more_accurate_than_jax_near_identity():
    """Within 1e-7 of I the JAX half angle cancels even in float64
    (measured 8.7e-13 off the SVD); the port stays at rounding (8.9e-16)."""
    F = np.tile(np.eye(2), (256, 1, 1)) + 1e-7 * np.random.default_rng(
        7).normal(size=(256, 2, 2))
    ref = _svd_clamp(F)
    err_port = np.abs(_port(F, torch.float64) - ref).max()
    err_jax = np.abs(_jax(F) - ref).max()
    assert err_port < 1e-13
    assert err_port <= err_jax


def test_float32_near_identity():
    """Float32 inputs whose exact clamp is ~I: the port's result is within
    float32 rounding of the SVD's (measured max error 2.4e-7; the JAX
    formula evaluated in float32 on the same inputs is 0.17 off)."""
    F = _near_pi().astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(_port(F, torch.float32), _svd_clamp(F),
                               rtol=0, atol=1e-6)
