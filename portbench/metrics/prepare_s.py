"""``prepare_s``: seconds of the program's ``prepare`` (the benchmark's
span around it): the host float64 operands and their cast to the card."""


def read(ctx):
    return ctx.prepare_s
