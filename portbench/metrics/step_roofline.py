"""``step_roofline.*``: the least time of the traced window's calls on the
card (each call's bytes at the memory rate or its operations at the
float32 rate, the larger; ``portbench/costs``) over the device's busy
time, in %."""

from portbench.costs.cell import bound_s, call_cost


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    contact = ctx.clamp_share * ctx.steps * ctx.sims
    least = ctx.calls * bound_s(*call_cost(ctx.shape, ctx.sims, ctx.steps,
                                           contact, root=ctx.root))
    return 100.0 * least / ctx.trace["busy_s"]
