"""``interval_clears_per_kstep.*``: steps on which kernel 5's per-mode
interval bound certified the floor after its Cauchy-Schwarz bound tripped
(the steps it took over from the exact y-row check), per 1,000 steps tier 1
committed: the program's counters ``k5.interval_clears`` and
``steps.tier1`` (``portbench/program_counters.py``).  None where the
program has no such counter."""

from portbench import program_counters


def read(ctx):
    c = program_counters.read()
    if c is None or "k5.interval_clears" not in c or not c["steps.tier1"]:
        return None
    return 1e3 * c["k5.interval_clears"] / c["steps.tier1"]
