"""The two padding rules of the port.

Counterpart of ``animsnapbases_tpu/utils/padding.py``, on numpy arrays and
torch tensors:

* :func:`pow2_pad` pads a timeline to the next power of two by repeating
  its last entry (the batched runners take such timelines, and step i
  reads entry min(i, T - 1));
* :func:`zero_pad_to_multiple` zero-pads an array that is split over a
  mesh axis to a multiple of the axis size.  A zero row never wins the
  argmax of the greedy selections (DEIM, the greedy position bases), so a
  sharded run picks as the unsharded one does.
"""

from __future__ import annotations

import numpy as np
import torch


def pow2_pad(a, axis: int = 0):
    """``a`` padded along ``axis`` to the next power-of-two length by
    repeating its last slice (as it is when already a power of two or
    empty)."""
    t = a.shape[axis]
    if t == 0:
        return a
    t_pad = 1 << max(t - 1, 0).bit_length()
    if t_pad <= t:
        return a
    if torch.is_tensor(a):
        last = a.narrow(axis, t - 1, 1)
        reps = [1] * a.dim()
        reps[axis] = t_pad - t
        return torch.cat([a, last.repeat(reps)], dim=axis)
    last = np.take(a, [-1], axis=axis)
    return np.concatenate([a, np.repeat(last, t_pad - t, axis=axis)],
                          axis=axis)


def zero_pad_to_multiple(a, axis: int, multiple: int):
    """``a`` zero-padded along ``axis`` to a multiple of ``multiple`` (as it
    is when already aligned)."""
    pad = (-a.shape[axis]) % multiple
    if not pad:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    if torch.is_tensor(a):
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    return np.concatenate([a, np.zeros(shape, dtype=a.dtype)], axis=axis)
