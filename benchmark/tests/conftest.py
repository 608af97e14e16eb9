"""Tests of the benchmark, on the CPU; those marked ``card`` need a CUDA
card and skip without one. Run from the root of the repository::

    python -m pytest benchmark/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on the CPU)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
