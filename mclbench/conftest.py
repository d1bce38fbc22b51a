"""Test settings of the benchmark's own tests (mclbench/tests)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card tests run on an "
                    "H100 (python3 -m pytest mclbench/tests -m card)")
    return torch.device("cuda")
