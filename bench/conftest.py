"""Settings for the benchmark's own tests (``bench/test_bench_*.py``).

``card`` marks a test that needs a CUDA card; it decides inside the
``card`` fixture whether one exists and skips there, never at import.
On the card: ``PYTHONPATH=src python -m pytest -m card bench -s``.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "`python -m pytest -m card bench -s`")
    return torch.device("cuda", 0)


@pytest.fixture
def few_threads():
    """Keep the CPU runs of the harness to two torch threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
