"""The collectives of the sharded paths, on a ``DeviceMesh`` axis.

The sharded paths use ``all_reduce``, ``broadcast`` and ``barrier`` only:
gloo's CUDA support covers these and no other, and the card's holds run
several ranks on one card over gloo, since NCCL refuses two ranks on one
card.  A gather is staged through an ``all_reduce`` of a zero-padded
buffer (:func:`gather_blocks`): each rank writes its block into zeros and
the sum is the gathered array, exact since x + 0 = x.  The greedy
selections' argmax over a split axis is one such gather of each rank's
best value, index and payload (:func:`argmax_pick`).

An array split over an axis of size n is cut into blocks of ceil(len / n)
(:func:`block_range`); the last blocks are short or empty, as the JAX
package's zero padding (``utils/padding.py``) would make them: a padded
row adds nothing and never wins an argmax, so none is computed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def as_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor on any device, or anything numpy takes) as a tensor
    of ``dtype`` on ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def require_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a ``DeviceMesh``, else ``TypeError``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def axis_of(mesh, axis: str):
    """(process group, size, this rank's index) of the named axis."""
    require_mesh(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    i = names.index(axis)
    return mesh.get_group(i), int(mesh.size(i)), int(mesh.get_local_rank(i))


def block_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """[lo, hi) of block ``index`` when ``n`` rows are cut into ``parts``
    blocks of ceil(n / parts)."""
    m = -(-n // parts)
    lo = min(index * m, n)
    return lo, min(lo + m, n)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (in place; returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_blocks(local: torch.Tensor, n: int, mesh, axis: str,
                  dim: int = 0) -> torch.Tensor:
    """The blocks of :func:`block_range` along ``dim``, one per rank of the
    axis, gathered into the full tensor of length ``n`` on every rank: an
    ``all_reduce`` of a zero-padded buffer (gloo's CUDA collectives have no
    all_gather)."""
    group, size, index = axis_of(mesh, axis)
    lo, hi = block_range(n, size, index)
    if local.shape[dim] != hi - lo:
        raise ValueError(f"rank block of {local.shape[dim]} rows, expected "
                         f"{hi - lo}")
    shape = list(local.shape)
    shape[dim] = n
    full = local.new_zeros(shape)
    full.narrow(dim, lo, hi - lo).copy_(local)
    return all_reduce_sum(full, group)


def argmax_pick(values: torch.Tensor, lo: int, payload_of, mesh,
                axis: str):
    """The argmax of a vector split over ``axis`` (this rank's block
    ``values`` starting at global index ``lo``) -> (global index, the
    winning value, ``payload_of(local index)`` of the winning rank), on
    every rank.  Ties go to the lowest index, as ``torch.argmax``'s do.
    One ``all_reduce`` of a (size, 2 + payload) buffer."""
    _, size, index = axis_of(mesh, axis)
    if values.numel():
        i = int(torch.argmax(values))
        best, payload = values[i], payload_of(i)
    else:
        i, best = 0, torch.tensor(-torch.inf, dtype=values.dtype,
                                  device=values.device)
        payload = payload_of(None)
    flat = payload.reshape(-1)
    buf = torch.zeros((size, 2 + flat.numel()), dtype=values.dtype,
                      device=values.device)
    buf[index, 0] = best
    buf[index, 1] = lo + i
    buf[index, 2:] = flat
    # the reduce sums exactly: every other row is zero, and -inf + 0 =
    # -inf for an empty block
    all_reduce_sum(buf, axis_of(mesh, axis)[0])
    win = int(torch.argmax(buf[:, 0]))
    return (int(buf[win, 1]), buf[win, 0],
            buf[win, 2:].reshape(payload.shape))
