"""The benchmark's tests: CPU tests at small sizes, and `card` tests that
need an NVIDIA GPU (each skips inside its fixture where there is none)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest -m card perfbench/tests)")
    return torch.device("cuda", 0)
