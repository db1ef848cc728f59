"""The program's own counters (``animsnapbases_tpu_torch/utils/
profiling.py`` ``counters``), for the readers of ``portbench/metrics``.

A run is one process (``run.py``), so the counters hold what the program
did in it: the warm-up call and the window's calls, all of the cell's
own shapes.  The readers take ratios of them, per step the program
served, so they need no reading before the window."""


def read():
    """Every counter of the program by name, or None where the program has
    no such registry."""
    try:
        from animsnapbases_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def entry_steps(c: dict, sims: int) -> float:
    """Steps of the entry point the program served: each step of
    ``run_steps`` once, on whichever tier served it, and each batched step
    of ``make_batched_run`` once (its sim-steps over the batch's sims)."""
    batched = c["sim_steps.batched_resident"] + c["sim_steps.batched_chunked"]
    return (c["steps.tier1"] + c["steps.contact_tier"] + c["steps.kernel1"]
            + batched / sims)
