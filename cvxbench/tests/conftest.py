"""The benchmark's own tests (not collected by the repository's tier-1
run). `pytest cvxbench/tests` from the root of the repository; tests
marked `card` need an NVIDIA GPU and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips on a CPU-only machine)")


@pytest.fixture(autouse=True)
def _one_thread():
    # small batched LU solves on the CPU misbehave under several threads
    # in some builds; one thread is also what the benchmark runs with
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    return torch.device("cuda")
