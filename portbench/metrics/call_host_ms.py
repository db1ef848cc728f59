"""``call_host_ms.*``: mean milliseconds of a call's span (the
benchmark's ``portbench.call``) in which the device ran nothing: the
entry point's host work, its transfers and its launches."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["calls"]:
        return None
    idle = [span - busy for span, busy in ctx.trace["calls"]]
    return 1e3 * sum(idle) / len(idle)
