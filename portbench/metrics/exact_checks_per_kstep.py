"""``exact_checks_per_kstep.*``: steps on which kernel 5 ran its exact
y-row check (its floor bound could not clear the floor), per 1,000 steps
tier 1 committed: the program's counters ``k5.exact_checks`` and
``steps.tier1`` (``portbench/program_counters.py``)."""

from portbench import program_counters


def read(ctx):
    c = program_counters.read()
    if c is None or not c["steps.tier1"]:
        return None
    return 1e3 * c["k5.exact_checks"] / c["steps.tier1"]
