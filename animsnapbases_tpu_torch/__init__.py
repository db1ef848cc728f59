"""animsnapbases_tpu_torch: the PyTorch/CUDA port of ``animsnapbases_tpu``.

It ports the reduced solver's serving path:

    DeformableModel -> AnimSnapBasesSolver(args).set_model(model)
        -> prepare(args) -> step() / run_steps()
                         -> make_batched_run() / make_batched_step()

with the fused iteration loop, the standard resident loop and the affine
loops as hand-written CUDA kernels for Hopper (``csrc/``), solo and batched
(an ensemble of sims per call), each beside its plain PyTorch version
(``ops/``).  The package imports torch, numpy and scipy, never JAX and
nothing of ``animsnapbases_tpu``.
"""

from animsnapbases_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
