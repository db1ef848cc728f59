"""``sim_steps_per_s``: sims x steps completed in the window over its
wall time."""


def read(ctx):
    return ctx.calls * ctx.sims * ctx.steps / ctx.window_s
