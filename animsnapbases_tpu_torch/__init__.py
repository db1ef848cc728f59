"""animsnapbases_tpu_torch: the PyTorch/CUDA port of ``animsnapbases_tpu``.

This slice ports the reduced solver's serving path:

    DeformableModel -> AnimSnapBasesSolver(args).set_model(model)
        -> prepare(args) -> step() / run_steps()

with the fused iteration loop and the standard resident multi-step loop as
hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version (``ops/fused_reduced.py``, ``ops/resident.py``).  The
package imports torch, numpy and scipy, never JAX and nothing of
``animsnapbases_tpu``.
"""

from animsnapbases_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
