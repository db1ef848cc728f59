"""``transfer_mb.*``: megabytes (1e6 bytes) the program moved between the
host and the card a call, both ways: its counters ``transfer.h2d_bytes``
and ``transfer.d2h_bytes`` over the calls it served
(``portbench/program_counters.py``)."""

from portbench import program_counters


def read(ctx):
    c = program_counters.read()
    if c is None:
        return None
    calls = program_counters.entry_steps(c, ctx.sims) / ctx.steps
    if calls <= 0:
        return None
    return (c["transfer.h2d_bytes"] + c["transfer.d2h_bytes"]) / 1e6 / calls
