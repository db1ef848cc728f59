"""SPLOCS sparse localized component optimization.

Counterpart of ``animsnapbases_tpu/bases/splocs.py``: block-coordinate
descent weight updates and ADMM component updates with l1/l2-prox
shrinkage, on the tensors' device.  The JAX scan's ``lax.cond`` on a
component's zero norm becomes arithmetic on the test's outcome (the
update adds and removes exact zeros for such a component), so that no
step reads anything back; the ADMM solves factor the (K, K) system once
(``torch.linalg.cholesky``) and back-substitute each iteration
(``torch.cholesky_solve``).  The outer iteration stays on the host, since
each iteration's regularization strength needs geodesic support maps.
"""

from __future__ import annotations

import math

import torch

from animsnapbases_tpu_torch.bases.greedy import project_weight


def update_weights(Rflat: torch.Tensor, C_flat: torch.Tensor,
                   W: torch.Tensor):
    """One sweep of block-coordinate-descent weight updates.

    Rflat (F, N*3) residual, C_flat (K, N*3) components, W (F, K).
    Returns (Rflat', W').  Components with ~zero norm get zero activation
    and leave the residual as it is."""
    Rf, W = Rflat.clone(), W.clone()
    for k in range(W.shape[1]):
        Ck = C_flat[k]
        ck_norm = Ck @ Ck
        safe = ck_norm > 1e-8
        # rank-1 updates in place; an unsafe component adds and removes
        # exact zeros
        Rf.addr_(torch.where(safe, W[:, k], 0.0), Ck)
        opt = (Rf @ Ck) / torch.where(safe, ck_norm, 1.0)
        wk = torch.where(safe, project_weight(opt), 0.0)
        Rf.addr_(wk, Ck, alpha=-1.0)
        W[:, k] = wk
    return Rf, W


def component_magnitude_argmax(C: torch.Tensor) -> torch.Tensor:
    """Per-component vertex of largest displacement, (K,) indices."""
    return torch.argmax((C ** 2).sum(dim=2), dim=1)


def prox_l1l2(Lambda: torch.Tensor, x: torch.Tensor,
              beta: float) -> torch.Tensor:
    """Group shrinkage over the last axis."""
    xlen = torch.sqrt((x ** 2).sum(dim=-1))
    shrink = torch.clamp(
        1.0 - beta * Lambda / torch.where(xlen == 0, 1.0, xlen), min=0.0)
    shrink = torch.where(xlen == 0, 0.0, shrink)
    return x * shrink[..., None]


def admm_update(C: torch.Tensor, U: torch.Tensor, W: torch.Tensor,
                Xflat: torch.Tensor, Lambda: torch.Tensor, rho: float,
                num_admm_iterations: int):
    """ADMM over components with a prefactored (K, K) Cholesky solve.

    C, U: (K, N, 3); W: (F, K); Xflat: (F, N*3); Lambda: (K, N).
    Returns (C', U', Z') after the fixed iteration count; the caller sets
    C <- Z as the reference does."""
    K = C.shape[0]
    G = W.T @ W
    c = W.T @ Xflat                       # (K, N*3)
    L = torch.linalg.cholesky(
        G + rho * torch.eye(K, dtype=C.dtype, device=C.device))
    Z = C
    for _ in range(num_admm_iterations):
        rhs = c + rho * (Z - U).reshape(c.shape)
        C = torch.cholesky_solve(rhs, L).reshape(C.shape)
        Z = prox_l1l2(Lambda, C + U, 1.0 / rho)
        U = U + C - Z
    return C, U, Z


def splocs_energy(Xflat: torch.Tensor, W: torch.Tensor, C: torch.Tensor,
                  Lambda: torch.Tensor):
    """(residual R (F,N,3), sparsity, E_rms, energy), each a tensor: the
    objective report of each outer iteration."""
    F = Xflat.shape[0]
    K, N, _ = C.shape
    R = Xflat - W @ C.reshape(K, -1)
    sparsity = (Lambda * torch.sqrt((C ** 2).sum(dim=2))).sum()
    E_rms = torch.linalg.vector_norm(R) / math.sqrt(3.0 * N * F)
    energy = (R ** 2).sum() + sparsity
    return R.reshape(F, N, 3), sparsity, E_rms, energy
