"""The benchmark's tests: on the CPU, and with the `cuda` marker on the
card (`python -m pytest benchmark/tests -m cuda` on a machine with one)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
