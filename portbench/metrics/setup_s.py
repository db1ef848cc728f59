"""``setup_s``: seconds from the start of ``run.py`` to the window: the
imports, the card, the bases (made on a checkout's first run, then read
from ``portbench/cache/``), the model, ``prepare``, the kernels' load (and
build on a checkout's first run) and one warm call of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
