"""Profiling: device traces, the program's spans and its counters.

Counterpart of ``animsnapbases_tpu/utils/profiling.py``.
:func:`device_trace` runs ``torch.profiler`` over the enclosed block (the
CPU, and the card where there is one) and writes a Chrome trace into
``log_dir``, which Perfetto or ``chrome://tracing`` opens.  The per-stage
wall clocks are ``utils/timing.py``'s.

Spans.  :func:`annotate` is the program's one span helper: while a
profiler records, a record-function range (in the same trace as the device
activity, on one clock); otherwise a shared no-op context, so a span costs
one check (~0.15 us) when nothing is traced.  The range is torch's fast
record function, an operator-scope range: unlike a user-scope
``torch.profiler.record_function`` it is not mirrored onto the card's
timeline, where a reader of the trace would take it for device work, and
it costs ~0.6 us against ~10.  The serving path's spans are named
``asb.*``; none sits inside a per-step loop:

* ``sim/reduced.py`` ``run_steps``: ``asb.run_steps`` around the tiered
  path (the recursion after a tier-1 exit nests in it), ``asb.to_device``
  and ``asb.to_host`` (``_to_device``, ``_to_host``), ``asb.host_check``
  (the float64 check of the step-0 predictor), ``asb.contact_tier`` (the
  contact tier's call);
* ``ops/affine_chunked.py`` ``_drive`` (kernel 5's outer loop):
  ``asb.tier1`` around the loop and per chunk ``asb.chunk.operands``,
  ``asb.chunk.launch``, ``asb.chunk.readback``, ``asb.chunk.advance``;
* ``make_batched_run``'s runner: ``asb.batched_run``, ``asb.pack`` and
  ``asb.unpack`` (``_pack``, ``_unpack``), ``asb.batched_kernel`` (the
  batched route's call), ``asb.gather_sims`` (with a mesh).

Counters.  :func:`counters` returns every counter of the program by name as
plain integers: the kernel wrappers' launch counters under their own names
(``fn.__name__``: ``affine_chunked``, ``affine_chunked[fold_vc=False]``,
...), which each wrapper module enters with :func:`register_launches` when
it is imported, the host counters (:data:`HOST_COUNTERS`, counted with
:func:`count`) and the device counters (:data:`DEVICE_COUNTERS`).  The
device counters live in one int64 block per device
(:func:`device_counts_ptr`), which the counted C entry points take as a
trailing ``counts`` pointer and add to with at most one ``atomicAdd`` per
sim per launch (per contact-mode step in kernel 3); the plain versions of
those kernels count the same quantities on the host under the same names.
The block is read only by :func:`counters`, with one synchronize per
device.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# counted on the host (``count``)
HOST_COUNTERS = (
    "transfer.h2d_bytes",          # bytes into the solver's tensors
    "transfer.d2h_bytes",          # bytes back to host arrays
    "steps.tier1",                 # run_steps: steps tier 1 committed
    "steps.contact_tier",          # run_steps: steps the contact tier ran
    "steps.kernel1",               # run_steps: steps on kernel 1
    "sim_steps.batched_resident",  # make_batched_run: sims x steps, kernel 3
    "sim_steps.batched_chunked",   # make_batched_run: sims x steps, 5 and 2
    "device.launches",             # kernels enqueued on the card
)
# counted on the card, slot by slot (csrc/affine.cuh COUNT_*), and by the
# plain versions on the host
DEVICE_COUNTERS = (
    "k5.exact_checks",     # steps kernel 5 ran its exact y-row check
    "k3.contact_steps",    # sim-steps kernel 3 ran in contact mode
    "k5.interval_clears",  # steps kernel 5's interval bound certified
)

_NOOP = contextlib.nullcontext()
_host = dict.fromkeys(HOST_COUNTERS + DEVICE_COUNTERS, 0)
_blocks: dict[torch.device, torch.Tensor] = {}
_launches: list = []


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """Trace the enclosed block into ``log_dir/trace_<ns>.json``; yields
    the profiler (None when not ``enabled``).

        with device_trace("traces/step"):
            solver.run_steps(f, 1000)
    """
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region of the trace while a profiler records; otherwise a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NOOP


def register_launches(*counters) -> None:
    """Enter launch counters (a ``launches`` int, named by ``__name__``) in
    :func:`counters`."""
    _launches.extend(counters)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    _host[name] += n


def count_bytes(name: str, *tensors) -> None:
    """Add the bytes of ``tensors`` to the transfer counter ``name``."""
    _host[name] += sum(t.numel() * t.element_size() for t in tensors)


def device_counts_ptr(device):
    """The address (``c_void_p``) of the device counters' int64 block on
    ``device``, one slot a name of ``DEVICE_COUNTERS``, zero when made, as
    the counted C entry points take it."""
    import ctypes

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    block = _blocks.get(device)
    if block is None:
        block = torch.zeros(len(DEVICE_COUNTERS), dtype=torch.int64,
                            device=device)
        _blocks[device] = block
    return ctypes.c_void_p(block.data_ptr())


def counters() -> dict[str, int]:
    """Every counter of the program by name, as plain integers: the launch
    counters, the host counters and the device counters (the host's count
    of a device counter's name, from the plain versions, plus every
    device block's; one synchronize per device block)."""
    out = {c.__name__: int(c.launches) for c in _launches}
    out.update(_host)
    for block in _blocks.values():
        for name, n in zip(DEVICE_COUNTERS, block.tolist()):
            out[name] += int(n)
    return out
