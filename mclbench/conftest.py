"""Test settings of the benchmark's own tests (mclbench/tests)."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # Workers that each spread torch's CPU ops over every core slow
        # each other down many times over: one thread a worker.
        import torch

        torch.set_num_threads(1)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card tests run on an "
                    "H100 (python3 -m pytest mclbench/tests -m card)")
    return torch.device("cuda")
