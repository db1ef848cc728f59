"""The port's entry-wise 3x3 strain projections
(``animsnapbases_tpu_torch.ops.strain3d``, also carried by the CUDA kernels
in ``csrc/strain3d.cuh``) against the JAX package's
``animsnapbases_tpu.ops.strain3d``, float64 on the CPU, on the same seeded
inputs: random F, F near I, inverted F (det F < 0), near-equal and equal
singular values, flat (rank 2) and collapsed (zero) F.  The port
transcribes the JAX Jacobi as written, so the two agree to rounding: the
tolerance is 1e-12 (measured: at most ~1e-14).  A rank-1 F has no unique
rotation (a ~1e-16 difference of the residue Gram-Schmidt divides by moves
R by ~1e-2 in either package): there both are held to be finite only.  The
clamp and the rotation are also held to numpy's SVD on the well-separated
random inputs (1e-9: five Jacobi sweeps converge past float64 precision
there)."""

import numpy as np
import pytest
import torch

from animsnapbases_tpu.ops import strain3d as jax_s3
from animsnapbases_tpu_torch.ops import strain3d

SMIN, SMAX = 0.95, 1.05
TOL = 1e-12


def _family(name, seed=0, n=96):
    rng = np.random.default_rng(seed)
    if name == "random":
        return rng.normal(size=(n, 3, 3))
    if name == "near_identity":
        return np.eye(3) + 1e-3 * rng.normal(size=(n, 3, 3))
    if name == "inverted":
        F = np.eye(3) + 0.2 * rng.normal(size=(n, 3, 3))
        F[:, :, 0] *= -1                      # det F < 0
        return F
    if name == "near_equal_singular_values":
        Q1 = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        Q2 = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        s = 1.0 + 1e-9 * rng.normal(size=(n, 3))
        s[::4] = 1.0                          # exactly equal
        return Q1 @ (s[:, :, None] * Q2)
    if name == "degenerate":
        F = rng.normal(size=(n, 3, 3))
        F[:, 2] = F[:, 0] + F[:, 1]           # rank 2: a flat tet
        F[::4] = 0.0                          # zero: a collapsed tet
        return F
    if name == "rank_one":
        F = rng.normal(size=(n, 3, 3))
        F[:, 1:] = 0.0
        return F
    raise ValueError(name)


FAMILIES = ["random", "near_identity", "inverted",
            "near_equal_singular_values", "degenerate"]


def _entries(F, lib):
    if lib == "torch":
        return tuple(torch.tensor(F[:, i, j]) for i in range(3)
                     for j in range(3))
    return tuple(F[:, i, j] for i in range(3) for j in range(3))


def _stack(m):
    return np.stack([np.asarray(x) for x in m], axis=-1).reshape(-1, 3, 3)


@pytest.mark.parametrize("family", FAMILIES)
def test_tet_strain_fhat_matches_jax(family):
    F = _family(family)
    got = _stack(strain3d.tet_strain_fhat(_entries(F, "torch"), SMIN, SMAX))
    want = _stack(jax_s3.tet_strain_fhat(_entries(F, "np"), SMIN, SMAX))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_polar_rotation_matches_jax(family):
    F = _family(family, seed=1)
    got = _stack(strain3d.polar_rotation(_entries(F, "torch")))
    want = _stack(jax_s3.polar_rotation(_entries(F, "np")))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("family", [f for f in FAMILIES
                                    if f != "near_equal_singular_values"])
def test_rotation_basis_matches_jax(family):
    """U, the sorted singular values and V of the rotation-parametrized
    SVD, with det U = det V = +1 (U = 0 for a zero F, in both packages).
    Near-equal singular values leave U and V free (only their products
    are held, above)."""
    F = _family(family, seed=2)
    U, s, V = strain3d.svd3_rotation_basis(_entries(F, "torch"))
    Uj, sj, Vj = jax_s3.svd3_rotation_basis(_entries(F, "np"))
    live = np.abs(F).max(axis=(1, 2)) > 0
    for a, b in ((U, Uj), (V, Vj)):
        np.testing.assert_allclose(_stack(a), _stack(b), rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.det(_stack(U))[live], 1.0,
                               atol=1e-9)
    np.testing.assert_allclose(np.linalg.det(_stack(V)), 1.0, atol=1e-9)
    # a flat tet's zero singular value is the square root of a rounding
    # residue of F^T F (~1e-16 |F|^2), so it agrees to ~1e-8 |F| only
    np.testing.assert_allclose(np.stack([x.numpy() for x in s]),
                               np.stack([np.asarray(x) for x in sj]),
                               rtol=0, atol=1e-7 if family == "degenerate"
                               else TOL)


def test_projections_match_numpy_svd():
    """On well-separated random F (det either sign): Fhat = U clip(S) V^T
    with the reference's inversion flip (the smallest singular value
    negated when det F < 0, then clamped) and R the nearest rotation."""
    F = _family("random", seed=3)
    fhat = _stack(strain3d.tet_strain_fhat(_entries(F, "torch"), SMIN, SMAX))
    rot = _stack(strain3d.polar_rotation(_entries(F, "torch")))
    for i in range(len(F)):
        U, s, Vt = np.linalg.svd(F[i])
        if np.linalg.det(U) < 0:
            U[:, 2] *= -1
            s[2] *= -1
        if np.linalg.det(Vt) < 0:
            Vt[2] *= -1
            s[2] *= -1
        np.testing.assert_allclose(
            fhat[i], U @ np.diag(np.clip(np.abs(s), SMIN, SMAX)) @ Vt,
            rtol=0, atol=1e-9)
        np.testing.assert_allclose(rot[i], U @ Vt, rtol=0, atol=1e-9)


def test_rank_one_stays_finite():
    """A rank-1 F: both packages give finite projections."""
    F = _family("rank_one", seed=4)
    for fn in (lambda e: strain3d.polar_rotation(e),
               lambda e: strain3d.tet_strain_fhat(e, SMIN, SMAX)):
        assert np.isfinite(_stack(fn(_entries(F, "torch")))).all()
    assert np.isfinite(_stack(jax_s3.polar_rotation(_entries(F, "np")))).all()


def test_float32_stays_finite_and_orthonormal():
    """In float32 (the card's type) the rotation of inverted and flat F
    stays a finite rotation (|R^T R - I| < 1e-5)."""
    F = np.concatenate([_family("inverted"), _family("degenerate")[1::4]])
    R = _stack(strain3d.polar_rotation(tuple(
        x.float() for x in _entries(F, "torch"))))
    assert np.isfinite(R).all()
    err = np.abs(np.einsum("nki,nkj->nij", R, R) - np.eye(3)).max()
    assert err < 1e-5
