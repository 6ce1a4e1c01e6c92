"""Settings of the benchmark's own tests (``python -m pytest mpnn_bench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which decides when the test runs (never at import)
whether a card is there, and skips without one.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)
