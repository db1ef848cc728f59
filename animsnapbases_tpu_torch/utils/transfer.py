"""Device-to-host copies in pieces.

Counterpart of ``animsnapbases_tpu/utils/transfer.py``: a large tensor
comes back to the host in leading-axis pieces of at most ``max_bytes``,
each written into one preallocated array, so the host never holds a
second full-size staging copy.
"""

from __future__ import annotations

import numpy as np
import torch

_CHUNK_BYTES = 24 << 20


def to_host_chunked(x, max_bytes: int = _CHUNK_BYTES) -> np.ndarray:
    """``x`` (a tensor, or anything numpy takes) as a numpy array, copied in
    leading-axis pieces of at most ``max_bytes``."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach()
    nbytes = x.numel() * x.element_size()
    if nbytes <= max_bytes or x.dim() == 0 or x.shape[0] <= 1:
        return x.cpu().numpy()
    row_bytes = max(nbytes // x.shape[0], 1)
    rows = max(int(max_bytes // row_bytes), 1)
    out = torch.empty(tuple(x.shape), dtype=x.dtype)
    for start in range(0, x.shape[0], rows):
        out[start:start + rows].copy_(x[start:start + rows])
    return out.numpy()
