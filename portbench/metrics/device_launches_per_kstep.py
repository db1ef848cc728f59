"""``device_launches_per_kstep.*``: kernels the program enqueued on the
card (its counter ``device.launches``: each launch of kernels 1 and 5, each
kernel the C loops of kernels 2-4 enqueue) per 1,000 steps of the entry
point it served (a batched step advances every sim;
``portbench/program_counters.py``)."""

from portbench import program_counters


def read(ctx):
    c = program_counters.read()
    if c is None:
        return None
    steps = program_counters.entry_steps(c, ctx.sims)
    if steps <= 0:
        return None
    return 1e3 * c["device.launches"] / steps
