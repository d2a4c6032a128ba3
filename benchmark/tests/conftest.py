"""The benchmark's own tests.  Most run on the CPU at small sizes; those
that need the card carry the `card` marker and skip, inside the `card`
fixture, where no CUDA device is found.  On the card:

    python3 -m pytest benchmark/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (this machine has none)")
    return torch.device("cuda", 0)
