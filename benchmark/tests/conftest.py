"""Tests of the benchmark itself, on the CPU at tiny sizes:

    python3 -m pytest benchmark/tests -q

Tests marked `gpu` run a cell on the card and skip without one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
