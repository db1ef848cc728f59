"""Closed-form 2x2 SVD sigma-clamp via rotation angles.

Counterpart of ``animsnapbases_tpu/ops/strain2d.py``: the same
trig-free formula, elementwise over tensors, so that the plain versions
of the kernels compute what the JAX emitters compute.  The CUDA kernels
carry the same formula in ``csrc/iteration.cuh`` (``clamped_fhat_2x2``).

For exactly rank-deficient F (sy == 0) the null-space orientation of the
SVD is arbitrary; this form picks sign(0) = +1.

Two deliberate differences from the JAX formula, each the same value in
exact arithmetic, found when the CUDA kernel was held against this plain
version on an H100 at the bench scene (ROADMAP Queue C):

* ``_half_angle`` takes cos x = sqrt((1 + c)/2) only for c >= 0, and
  |sin x| = sqrt((1 - c)/2) for c < 0, the other value from s / (2 .).
  The JAX form always takes sqrt((1 + c)/2), which cancels as c -> -1
  (F00 < F11 with a tiny shear, common near F ~ I): there float32 noise of
  c and s leaves (cos x, sin x) far from a unit vector and a projection
  row wrong by tens of percent (measured 0.356 for 1.000 in one row).
* Q and R are taken with ``hypot``, not ``sqrt(x*x + y*y)``: near F ~ I
  the off-diagonal residues can be ~1e-20, whose float32 squares are
  subnormal and keep only a few digits, so (Fv, G)/R would again not be a
  unit vector.
"""

from __future__ import annotations

import torch


def _half_angle(c2, s2):
    """(cos x, sin x) from (cos 2x, sin 2x), branch-free; x in
    (-pi/2, pi/2] (cos x >= 0).  Each branch takes the root of the larger
    of (1 + c2)/2 and (1 - c2)/2 and the other value from s2, so neither
    root cancels (see the module docstring)."""
    sgn = torch.where(s2 >= 0, 1.0, -1.0).to(c2.dtype)
    # both roots clamped to their own branch's range (>= 1/2), which leaves
    # the chosen one unchanged and keeps the unchosen division finite
    h_p = torch.sqrt(torch.clamp((1.0 + c2) * 0.5, min=0.5))  # cos x, c2 >= 0
    h_n = torch.sqrt(torch.clamp((1.0 - c2) * 0.5, min=0.5))  # |sin x|, c2 < 0
    pos = c2 >= 0
    cx = torch.where(pos, h_p, torch.abs(s2) / (2.0 * h_n))
    sx = torch.where(pos, s2 / (2.0 * h_p), sgn * h_n)
    return cx, sx


def clamped_fhat_2x2(a, b, c, d, smin: float, smax: float):
    """Entries of Fhat = U clip(Sigma) V^T for F = [[a, b], [c, d]],
    elementwise over tensors of any shape.  Returns (f00, f01, f10, f11)."""
    E = (a + d) * 0.5
    Fv = (a - d) * 0.5
    G = (c + b) * 0.5
    H = (c - b) * 0.5
    # hypotenuses without squaring (see the module docstring)
    Q = torch.hypot(E, H)
    R = torch.hypot(Fv, G)
    sx = Q + R
    sy = Q - R                       # signed; negative iff det(F) < 0

    invQ = 1.0 / torch.clamp(Q, min=1e-30)
    invR = 1.0 / torch.clamp(R, min=1e-30)
    ok_q = Q > 1e-30
    ok_r = R > 1e-30
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    ca1 = torch.where(ok_r, Fv * invR, one)
    sa1 = torch.where(ok_r, G * invR, zero)
    ca2 = torch.where(ok_q, E * invQ, one)
    sa2 = torch.where(ok_q, H * invQ, zero)
    c1, s1 = _half_angle(ca1, sa1)     # psi1 = a1/2
    c2, s2_ = _half_angle(ca2, sa2)    # psi2 = a2/2
    # phi = psi2 + psi1 ; theta = psi1 - psi2
    cp = c2 * c1 - s2_ * s1
    sp = s2_ * c1 + c2 * s1
    ct = c1 * c2 + s1 * s2_
    st = s1 * c2 - c1 * s2_

    shx = torch.clamp(sx, smin, smax)
    sgn = torch.where(sy >= 0, 1.0, -1.0).to(a.dtype)
    shy = sgn * torch.clamp(torch.abs(sy), smin, smax)
    f00 = shx * cp * ct + shy * sp * st
    f01 = shx * cp * st - shy * sp * ct
    f10 = shx * sp * ct - shy * cp * st
    f11 = shx * sp * st + shy * cp * ct
    return f00, f01, f10, f11
