"""Non-negative weights of the greedy deflation extraction.

Counterpart of ``project_weight`` and ``signed_nonneg_weight`` of
``animsnapbases_tpu/bases/greedy.py``, the weights of the greedy
deflation in ``bases/constraints.py``.
"""

from __future__ import annotations

import torch


def project_weight(x: torch.Tensor) -> torch.Tensor:
    """Non-negative cone projection, normalized to max 1."""
    x = torch.clamp(x, min=0.0)
    mx = x.max()
    return torch.where(mx == 0, x, x / torch.where(mx == 0, 1.0, mx))


def signed_nonneg_weight(wk: torch.Tensor) -> torch.Tensor:
    """The larger (in norm) of the projections of +wk and -wk onto the
    non-negative cone."""
    wp = project_weight(wk)
    wn = project_weight(-wk)
    return torch.where(torch.linalg.vector_norm(wp)
                       > torch.linalg.vector_norm(wn), wp, wn)
