"""The control: the reference in TF32, put in the program's place, fails
the check.  On the CPU at test sizes against the test's float64 limit; on
the card at the cells' own sizes against the committed limits."""

import pytest
import torch

from portbench import core
from portbench.tests.tiny import ROOT, tiny_root


@pytest.mark.parametrize("cell", ["cloth120.serve", "bar40.serve",
                                  "cloth120.ensemble64"])
def test_control_fails_at_test_size(tmp_path, cell):
    root = tiny_root(tmp_path)
    res = core.run(root, cell, 4242, 0.1, False, device="cpu",
                   control="tf32")
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cloth120.serve", "bar40.serve",
                                  "cloth120.ensemble64"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 987654321])
def test_control_fails_on_the_card(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at the cells' sizes")
    res = core.run(ROOT, cell, seed, 1.0, False, device="cuda",
                   control="tf32")
    assert not res["correct"], res["checks"]
