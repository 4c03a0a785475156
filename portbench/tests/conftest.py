"""The benchmark's tests.  ``card``: a test that needs the NVIDIA card; it
decides inside its body (the ``card`` fixture) and skips with a reason
where there is none, never at import or collection."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
