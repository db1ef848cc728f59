"""Device and dtype policy of the port.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card
they raise unless the caller asked for the CPU: nothing carries on
silently on the CPU.  The working dtype is float32 on the card and
float64 on the CPU (the parity tests against the JAX package run there).
The storage dtype of the large per-step matrices (``matmul_dtype``) is
float32 or bfloat16 on the card, as ``AnimSnapBasesSolver.matmul_dtype``
is in the JAX package; accumulation stays in the working dtype.
The full-order recorder (``sim/solver.py``) and the bases pipeline
(``bases/``, ``ops/podlinalg.py``, ``ops/deim_scan.py``) run in
``PIPELINE_DTYPE``, float64, on the card and on the CPU alike, as the JAX
bench records and builds them: a float32 recording would diverge at the
chaotic free-swinging vertices.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"
PIPELINE_DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """The torch device for ``device`` (default ``"cuda"``).  Raises
    ``RuntimeError`` when a CUDA device is asked for and none is present.
    On a CUDA device, float32 matrix products are pinned to full float32
    (TF32 off), since the plain versions compare with the kernels there."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def working_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """The dtype of state and small operands: float32 on the card (the
    only dtype its kernels take), float64 or float32 on the CPU (float64
    by default)."""
    if device.type == "cuda":
        if dtype not in (None, torch.float32):
            raise ValueError(f"the card runs float32 state, not {dtype}")
        return torch.float32
    if dtype not in (None, torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    return torch.float64 if dtype is None else dtype


def storage_dtype(dtype: torch.dtype, matmul_dtype=None) -> torch.dtype:
    """The storage dtype of the big (3, r, N) matrices (default: ``dtype``):
    float32 or bfloat16 beside float32 state, float64 beside float64
    state."""
    mm = dtype if matmul_dtype is None else matmul_dtype
    if dtype == torch.float64 and mm != torch.float64:
        raise ValueError("float64 state stores its matrices in float64")
    if dtype == torch.float32 and mm not in (torch.float32, torch.bfloat16):
        raise ValueError(f"float32 state stores its matrices in float32 or "
                         f"bfloat16, not {mm}")
    return mm
