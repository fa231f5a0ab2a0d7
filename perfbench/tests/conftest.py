"""Tests of the benchmark harness (run: python -m pytest perfbench/tests).

They run on the CPU. Tests marked `card` need a CUDA device: the `card`
fixture decides inside the test whether there is one and skips otherwise.
On the card: python -m pytest perfbench/tests -m card
"""
import os
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)
for p in (ROOT, PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
