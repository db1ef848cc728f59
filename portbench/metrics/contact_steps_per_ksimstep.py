"""``contact_steps_per_ksimstep.*``: sim-steps batched kernel 3 ran in
contact mode, per 1,000 sim-steps it served: the program's counters
``k3.contact_steps`` and ``sim_steps.batched_resident``
(``portbench/program_counters.py``)."""

from portbench import program_counters


def read(ctx):
    c = program_counters.read()
    if c is None or not c["sim_steps.batched_resident"]:
        return None
    return 1e3 * c["k3.contact_steps"] / c["sim_steps.batched_resident"]
