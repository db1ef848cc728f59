"""Carry the JAX package's prepared state across to the port's kernels.

``operands_from_numpy`` takes the numpy arrays the JAX package prepares
(``prepare_fused_operands``' dict, ``UG_allT`` included, and, for the
resident and affine kernels, ``AnimSnapBasesSolver._resident_state``) and
returns the port's kernel operands on a given device and dtype: every
group kind of the JAX package, in DEIM row form and block form, the
weighted star rows of ``verts_bending`` included (``fused_operands`` keeps
``G_allT`` as sparse columns).  A test can then feed both packages the
same operands, independent of the port's own ``prepare``.  Nothing
here imports the JAX package: the inputs are plain numpy arrays, lists
and tuples.
"""

from __future__ import annotations

import numpy as np

from animsnapbases_tpu_torch.ops.affine import (
    AffineOperands,
    affine_operands,
)
from animsnapbases_tpu_torch.ops.fused_reduced import (
    FusedOperands,
    fused_operands,
)
from animsnapbases_tpu_torch.ops.resident import (
    ResidentOperands,
    resident_operands,
)


def operands_from_numpy(ops: dict, device, dtype, resident_state=None,
                        matmul_dtype=None, dt: float | None = None,
                        eta: float = 1.0, floor: bool = False,
                        floor_h: float = 0.0, affine: bool = False
                        ) -> tuple[FusedOperands,
                                   ResidentOperands | AffineOperands | None]:
    """(fused operands, resident operands or None).

    ``ops``: ``C_allT``, ``inv3``, ``WT_all``, ``G_allT``, ``flat_arrays``,
    ``layout``, ``gather_slices`` and, for the affine kernels, ``UG_allT``.
    ``resident_state``: ``U_liftT``, ``ut_acT``, ``mass_inv``, ``perm``,
    ``iperm``, ``n_sel`` and, with ``affine=True`` (the second result is
    then the affine operands), ``M_utac`` and ``U_selT``; it needs ``dt``
    (and takes ``eta``, ``floor``, ``floor_h``), which the JAX package binds
    when it builds the kernel rather than storing them."""
    fused = fused_operands(ops, device, dtype)
    if resident_state is None:
        return fused, None
    if dt is None:
        raise ValueError("the resident operands need dt")
    st = resident_state
    res = resident_operands(
        fused, np.asarray(st["U_liftT"], np.float64),
        np.asarray(st["ut_acT"], np.float64),
        np.asarray(st["mass_inv"], np.float64), st["perm"], st["iperm"],
        st["n_sel"], dt=dt, eta=eta, floor=floor, floor_h=floor_h,
        matmul_dtype=matmul_dtype)
    if affine:
        res = affine_operands(res, np.asarray(st["M_utac"], np.float64),
                              np.asarray(st["U_selT"], np.float64))
    return fused, res
