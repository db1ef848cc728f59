"""Entry-wise 3x3 strain projections of the tet constraints.

Counterpart of ``animsnapbases_tpu/ops/strain3d.py``: the same cyclic
Jacobi with branch-free rotations (5 sweeps), the same 3-sort network
that keeps det V = +1, and the same rotation-parametrized SVD
F = U diag(s0, s1, +-s2) V^T with det U = det V = +1, elementwise over
tensors, so that the plain versions of the kernels compute what the JAX
emitters ``_tet_p`` compute.  The CUDA kernels carry the same arithmetic
in ``csrc/strain3d.cuh``.

In that basis both projections lose all sign logic:

* the tet strain clamp: Fhat = U diag(clip s0, clip s1, clip s2) V^T;
* the polar rotation: R = U V^T;

the reference's inversion flip re-signs the third mode into the nearest
non-inverted target, which the det-+1 parametrization produces natively.

Matrices are tuples of 9 entry tensors in row-major order
(m00, m01, m02, m10, m11, m12, m20, m21, m22).
"""

from __future__ import annotations

import torch

_EPS = 1e-30
SWEEPS = 5


def _rotation(app, aqq, apq):
    """Branch-free Jacobi rotation (c, s); sign(0) taken as +1."""
    small = apq.abs() < _EPS
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def eigh3_entries(a00, a01, a02, a11, a12, a22, sweeps: int = SWEEPS):
    """Cyclic Jacobi on the entries of a symmetric 3x3 matrix ->
    ((w0, w1, w2), V entries (9,)), V accumulated from rotations (det V =
    +1), eigenpairs unsorted."""
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    v = [one, zero, zero, zero, one, zero, zero, zero, one]

    def rotate_v(p, q, c, s):
        for i in range(3):
            vp, vq = v[3 * i + p], v[3 * i + q]
            v[3 * i + p], v[3 * i + q] = c * vp - s * vq, s * vp + c * vq

    for _ in range(sweeps):
        # rotation (0, 1)
        c, s = _rotation(a00, a11, a01)
        a00, a11 = (c * c * a00 - 2 * c * s * a01 + s * s * a11,
                    s * s * a00 + 2 * c * s * a01 + c * c * a11)
        a02, a12 = c * a02 - s * a12, s * a02 + c * a12
        a01 = zero
        rotate_v(0, 1, c, s)
        # rotation (0, 2)
        c, s = _rotation(a00, a22, a02)
        a00, a22 = (c * c * a00 - 2 * c * s * a02 + s * s * a22,
                    s * s * a00 + 2 * c * s * a02 + c * c * a22)
        a01, a12 = c * a01 - s * a12, s * a01 + c * a12
        a02 = zero
        rotate_v(0, 2, c, s)
        # rotation (1, 2)
        c, s = _rotation(a11, a22, a12)
        a11, a22 = (c * c * a11 - 2 * c * s * a12 + s * s * a22,
                    s * s * a11 + 2 * c * s * a12 + c * c * a22)
        a01, a02 = c * a01 - s * a02, s * a01 + c * a02
        a12 = zero
        rotate_v(1, 2, c, s)
    return (a00, a11, a22), tuple(v)


def _swap_cols(w, v, i, j):
    """Compare-swap eigenpair columns i > j by eigenvalue, branch-free; the
    swapped column j is negated, which keeps det V = +1."""
    do = w[j] > w[i]
    w, v = list(w), list(v)
    w[i], w[j] = torch.where(do, w[j], w[i]), torch.where(do, w[i], w[j])
    for r in range(3):
        a, b = v[3 * r + i], v[3 * r + j]
        v[3 * r + i], v[3 * r + j] = torch.where(do, b, a), torch.where(do,
                                                                        -a, b)
    return tuple(w), tuple(v)


def svd3_rotation_basis(f, sweeps: int = SWEEPS):
    """Rotation-parametrized SVD of F (9 entries) -> (U entries, (s0, s1,
    s2), V entries): s sorted descending and non-negative, det U = det V =
    +1, F = U diag(s0, s1, +-s2) V^T."""
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = f
    a00 = f00 * f00 + f10 * f10 + f20 * f20
    a01 = f00 * f01 + f10 * f11 + f20 * f21
    a02 = f00 * f02 + f10 * f12 + f20 * f22
    a11 = f01 * f01 + f11 * f11 + f21 * f21
    a12 = f01 * f02 + f11 * f12 + f21 * f22
    a22 = f02 * f02 + f12 * f12 + f22 * f22

    w, v = eigh3_entries(a00, a01, a02, a11, a12, a22, sweeps=sweeps)
    w, v = _swap_cols(w, v, 0, 1)
    w, v = _swap_cols(w, v, 1, 2)
    w, v = _swap_cols(w, v, 0, 1)
    s0, s1, s2 = (torch.sqrt(torch.clamp(x, min=0.0)) for x in w)

    v00, v01, v02, v10, v11, v12, v20, v21, v22 = v
    # B = F V; columns b_j = s_j u_j (the third signed)
    b00 = f00 * v00 + f01 * v10 + f02 * v20
    b10 = f10 * v00 + f11 * v10 + f12 * v20
    b20 = f20 * v00 + f21 * v10 + f22 * v20
    b01 = f00 * v01 + f01 * v11 + f02 * v21
    b11 = f10 * v01 + f11 * v11 + f12 * v21
    b21 = f20 * v01 + f21 * v11 + f22 * v21

    inv0 = 1.0 / torch.clamp(s0, min=_EPS)
    u00, u10, u20 = b00 * inv0, b10 * inv0, b20 * inv0
    # Gram-Schmidt the second column
    dot01 = u00 * b01 + u10 * b11 + u20 * b21
    r01, r11, r21 = b01 - dot01 * u00, b11 - dot01 * u10, b21 - dot01 * u20
    n1 = torch.sqrt(r01 * r01 + r11 * r11 + r21 * r21)
    inv1 = 1.0 / torch.clamp(n1, min=_EPS)
    u01, u11, u21 = r01 * inv1, r11 * inv1, r21 * inv1
    # third column: the right-handed completion (det U = +1)
    u02 = u10 * u21 - u20 * u11
    u12 = u20 * u01 - u00 * u21
    u22 = u00 * u11 - u10 * u01
    U = (u00, u01, u02, u10, u11, u12, u20, u21, u22)
    return U, (s0, s1, s2), v


def _compose_u_diag_vt(U, d, V):
    """Entries of U diag(d) V^T."""
    d0, d1, d2 = d
    out = []
    for i in range(3):
        for j in range(3):
            out.append(U[3 * i] * d0 * V[3 * j] + U[3 * i + 1] * d1
                       * V[3 * j + 1] + U[3 * i + 2] * d2 * V[3 * j + 2])
    return tuple(out)


def tet_strain_fhat(f, smin: float, smax: float, sweeps: int = SWEEPS):
    """The clamped deformation gradient Fhat (9 entries)."""
    U, s, V = svd3_rotation_basis(f, sweeps=sweeps)
    return _compose_u_diag_vt(
        U, tuple(torch.clamp(x, min=smin, max=smax) for x in s), V)


def polar_rotation(f, sweeps: int = SWEEPS):
    """The closest rotation R = U V^T (9 entries)."""
    U, _, V = svd3_rotation_basis(f, sweeps=sweeps)
    one = torch.ones_like(f[0])
    return _compose_u_diag_vt(U, (one, one, one), V)
