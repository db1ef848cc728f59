"""The check against a broken timed path: the whole run but the look for a
card, at test sizes on the CPU (float64, limit 1e-4 of the rollout's
largest displacement), with the entry point broken underneath.  Sound runs
come out correct and every fault comes out not correct.  (The cells run on
one card: there is no exchange between cards to leave out.)"""

import pytest

from portbench import core
from portbench.tests.tiny import tiny_root


def unchanged(call):
    """A step that returns its state unchanged."""
    def broken(P0, V0, F):
        call(P0, V0, F)
        return P0.copy(), V0.copy()
    return broken


def half_batch(call):
    """Half of the batch left out: its sims come back as they went in."""
    def broken(P0, V0, F):
        P, V = call(P0, V0, F)
        P, V = P.copy(), V.copy()
        half = P.shape[0] // 2
        P[half:], V[half:] = P0[half:], V0[half:]
        return P, V
    return broken


def altered(call):
    """An answer altered where it is produced: one vertex of every answer
    moved by half a unit along x, and its velocity by half a unit a
    second."""
    def broken(P0, V0, F):
        P, V = call(P0, V0, F)
        P, V = P.copy(), V.copy()
        P[..., 7, 0] += 0.5
        V[..., 7, 0] += 0.5
        return P, V
    return broken


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", ["cloth120.serve", "bar40.serve",
                                  "cloth120.ensemble64"])
def test_sound_runs_are_correct(root, cell):
    res = core.run(root, cell, 2 ** 31 + 17, 0.3, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", [
    ("cloth120.serve", unchanged), ("cloth120.serve", altered),
    ("bar40.serve", unchanged), ("bar40.serve", altered),
    ("cloth120.ensemble64", unchanged), ("cloth120.ensemble64", half_batch),
    ("cloth120.ensemble64", altered)])
def test_faults_are_caught(root, cell, fault):
    res = core.run(root, cell, 2 ** 31 + 23, 0.3, False, device="cpu",
                   hooks={"call": fault})
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
