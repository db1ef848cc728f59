"""Branch-free small-matrix decompositions, batched over leading axes.

Counterpart of ``animsnapbases_tpu/ops/svd3.py``: the same cyclic Jacobi
eigensolver with branch-free rotations (6 sweeps for 3x3), the same
closed-form 2x2 eigensolver, the same SVD from the eigendecomposition of
F^T F with a Gram-Schmidt U and its basis-vector fallback, the same polar
rotation and dominant-mode routine.  Every function takes matrices with
any leading batch axes, ``(..., n, n)``, where the JAX functions take one
matrix under ``vmap``.

The full-order recorder projects ``tris_strain`` through :func:`svd2x2`
(``sim/projections.py``), as the JAX recorder does, so that its
p-snapshots and through them the DEIM picks are the JAX package's.  The
reduced path keeps its closed-form clamp (``ops/strain2d.py``).
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def _grad_safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt for x > 0, 0 otherwise, with a zero derivative at x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)),
                       torch.zeros_like(x))


def floor_at(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with JAX's gradient at a tie: ``jnp.maximum`` (and
    ``jnp.clip``) split the cotangent in half where x == lo, ``torch.clamp``
    passes all of it to x; ``torch.maximum`` splits it as JAX does.  The
    values equal ``torch.clamp``'s bit for bit.  ``lo`` rides as a 0-dim
    CPU tensor, a scalar argument of the kernel on any device."""
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype))


# ---------------------------------------------------------------------------
# symmetric eigendecomposition via cyclic Jacobi
# ---------------------------------------------------------------------------

def _jacobi_rotation(app, aqq, apq):
    """Givens rotation (c, s) annihilating the off-diagonal apq; sign(0) of
    tau is +1, so equal diagonal entries still rotate by 45 degrees."""
    small = apq.abs() < _EPS
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(tau.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _with(X, p, q, Xp, Xq, axis):
    """X with its columns (axis -1) or rows (axis -2) p and q replaced by
    Xp and Xq, out of place: autograd saves the operands of the products
    that made Xp and Xq, which a write into X would change."""
    parts = [Xp if j == p else Xq if j == q else X.select(axis, j)
             for j in range(X.shape[axis])]
    return torch.stack(parts, dim=axis)


def _apply_jacobi(A, V, p, q):
    """A <- G^T A G and V <- V G for the rotation G in rows/cols (p, q)."""
    c, s = _jacobi_rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    c, s = c[..., None], s[..., None]
    Ap = c * A[..., :, p] - s * A[..., :, q]
    Aq = s * A[..., :, p] + c * A[..., :, q]
    A = _with(A, p, q, Ap, Aq, -1)
    Ap = c * A[..., p, :] - s * A[..., q, :]
    Aq = s * A[..., p, :] + c * A[..., q, :]
    A = _with(A, p, q, Ap, Aq, -2)
    Vp = c * V[..., :, p] - s * V[..., :, q]
    Vq = s * V[..., :, p] + c * V[..., :, q]
    return A, _with(V, p, q, Vp, Vq, -1)


def jacobi_eigh3(S: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric (..., 3, 3): (eigenvalues (..., 3)
    descending, eigenvectors (..., 3, 3) as columns)."""
    A = S
    V = torch.eye(3, dtype=S.dtype, device=S.device).expand_as(S)
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = _apply_jacobi(A, V, p, q)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(-w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(V, -1, order[..., None, :].expand_as(V)))


def jacobi_eigh2(S: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 2, 2), descending."""
    a, b, d = S[..., 0, 0], S[..., 0, 1], S[..., 1, 1]
    tr = a + d
    diff = a - d
    rad = _grad_safe_sqrt(diff * diff + 4.0 * b * b)
    w = torch.stack([0.5 * (tr + rad), 0.5 * (tr - rad)], dim=-1)
    c, s = _jacobi_rotation(a, d, b)
    # the rotation convention of _apply_jacobi: new col0 = c*e0 - s*e1
    V = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    # the diagonal of V^T S V decides which column has the larger value
    v0 = V[..., :, 0]
    d0 = (v0 * (S @ v0[..., None])[..., 0]).sum(-1)
    V = torch.where((d0 < 0.5 * tr)[..., None, None], V.flip(-1), V)
    return w, V


# ---------------------------------------------------------------------------
# SVD of 3x3 / 2x2 via the eigendecomposition of F^T F
# ---------------------------------------------------------------------------

def _orthonormal_u(B: torch.Tensor, sigma: torch.Tensor):
    """Columns of U from B = F V = U diag(sigma): Gram-Schmidt on the
    columns of B, with a basis vector in place of a column whose singular
    value is below the eigensolver's noise; always orthonormal."""
    n = B.shape[-1]
    eps = torch.finfo(B.dtype).eps
    thresh = 16.0 * eps ** 0.5 * (sigma[..., 0] + _EPS)
    cand = torch.eye(n, dtype=B.dtype, device=B.device)

    def dot(x, y):
        return (x * y).sum(-1, keepdim=True)

    cols = []
    for i in range(n):
        v = B[..., :, i]
        for pc in cols:
            v = v - dot(v, pc) * pc
        vn = _grad_safe_sqrt((v * v).sum(-1))
        ok = (sigma[..., i] > thresh) & (vn > _EPS)
        # fallback: the basis vector least aligned with the columns so far
        scores = torch.zeros(B.shape[:-2] + (n,), dtype=B.dtype,
                             device=B.device)
        for pc in cols:
            scores = scores + (pc @ cand.T) ** 2
        alt = cand[torch.argmin(scores, dim=-1)]
        for pc in cols:
            alt = alt - dot(alt, pc) * pc
        alt = alt / floor_at(_grad_safe_sqrt((alt * alt).sum(-1)),
                             _EPS)[..., None]
        cols.append(torch.where(ok[..., None],
                                v / floor_at(vn, _EPS)[..., None],
                                alt))
    return torch.stack(cols, dim=-1)


def svd3x3(F: torch.Tensor):
    """F = U diag(s) V^T for (..., 3, 3): s descending and non-negative,
    U and V orthogonal.  Returns (U, s, V^T)."""
    w, V = jacobi_eigh3(F.transpose(-1, -2) @ F)
    sigma = _grad_safe_sqrt(w)
    return _orthonormal_u(F @ V, sigma), sigma, V.transpose(-1, -2)


def svd2x2(F: torch.Tensor):
    """F = U diag(s) V^T for (..., 2, 2), s descending and non-negative."""
    w, V = jacobi_eigh2(F.transpose(-1, -2) @ F)
    sigma = _grad_safe_sqrt(w)
    return _orthonormal_u(F @ V, sigma), sigma, V.transpose(-1, -2)


def polar_rotation3x3(F: torch.Tensor):
    """Rotation R = U V^T of the polar decomposition F = R S, with det R =
    +1 kept by flipping the last column of U."""
    U, _, Vt = svd3x3(F)
    flip = torch.linalg.det(U @ Vt) < 0
    sign = torch.where(flip, -1.0, 1.0).to(U.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * sign[..., None, None]],
                  dim=-1)
    return U @ Vt


# ---------------------------------------------------------------------------
# dominant mode of a (d, F) trajectory via its d x d Gram matrix
# ---------------------------------------------------------------------------

def top_mode_rows(X: torch.Tensor):
    """Dominant singular triple of X (..., d, F), d in {2, 3}: (sigma0, w)
    with w = sigma0 * (the first right singular vector) = u0^T X.  The sign
    is arbitrary, as with any SVD."""
    d = X.shape[-2]
    G = X @ X.transpose(-1, -2)
    if d == 3:
        w, V = jacobi_eigh3(G)
    elif d == 2:
        w, V = jacobi_eigh2(G)
    else:
        raise ValueError("top_mode_rows supports d in {2, 3}")
    sigma0 = torch.sqrt(floor_at(w[..., 0], 0.0))
    return sigma0, (V[..., :, 0:1] * X).sum(-2)
