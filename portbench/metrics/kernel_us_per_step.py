"""``kernel_us_per_step.*``: device microseconds of the program's kernels
(names in the ``ksm::`` namespace) in the traced window, per step of the
entry point."""


def read(ctx):
    if ctx.trace is None or ctx.trace["kernel_s"] <= 0:
        return None
    return 1e6 * ctx.trace["kernel_s"] / (ctx.calls * ctx.steps)
