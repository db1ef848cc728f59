"""``steps_per_s``: every step completed in the window over its wall
time (a closed loop of one client: calls back to back, each ending in
``torch.cuda.synchronize()``)."""


def read(ctx):
    return ctx.calls * ctx.steps / ctx.window_s
