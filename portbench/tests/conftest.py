"""CPU tests of the benchmark harness (``python -m pytest portbench/tests``
from the checkout's root).  Tests marked ``card`` need an NVIDIA card and
skip without one, deciding inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one torch thread each, beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
