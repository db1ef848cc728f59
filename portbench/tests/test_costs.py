"""The cost counts at a small shape against a hand count."""

import pytest

from portbench.costs.cell import PEAKS, bound_s, call_cost


def test_call_cost_by_hand():
    shape = {"n": 100, "r": 4, "n_sel": 10,
             "rows": {"tris_strain": 3, "edge_spring": 2}, "iterations": 2,
             "matrix_bytes": 4}
    nbytes, ops = call_cost(shape, sims=2, steps=5, contact_steps=3)
    # per call: 2 sims x (3 in + 2 out) x 3N floats; two (3, 4, 100)
    # matrices; small operands: Ar^-1 48, U rows 120, W 60, rest 60 floats
    small = 4 * (48 + 120 + 60 + 60)
    contact = 3 * (4 * 2 * 4 * 100 + 4 * 5 * 100)
    assert nbytes == 4 * 2 * 15 * 100 + 4 * 2 * 3 * 4 * 100 + small + contact
    # per sim-step: 2 x (96 + 240 + 3 x 110 + 2 x 20 + 120) + 96
    step = 2 * (96 + 240 + 330 + 40 + 120) + 96
    assert ops == 2 * 5 * step + 2 * 4800 + 3 * 1600


def test_bound_takes_the_larger_time():
    assert bound_s(PEAKS["hbm_bytes_per_s"], 1.0) == pytest.approx(1.0)
    assert bound_s(1.0, PEAKS["flops_per_s"]["float32"]) == pytest.approx(
        1.0)
