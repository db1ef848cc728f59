"""``launches_per_kstep.*``: the program's wrapper launches over the
window (its launch counters, read before and after), per 1,000 steps of
the entry point (a batched call's step advances every sim)."""


def read(ctx):
    return 1e3 * ctx.launches / (ctx.calls * ctx.steps)
