"""pytest settings of the benchmark's own tests (``python -m pytest
ptbench/tests``): the ``card`` marker for tests that need an NVIDIA card,
which decide in a fixture, never at import, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control at the cells' sizes runs on "
                    "the card (python3 -m ptbench.calibrate)")
    return torch.device("cuda")
