"""The benchmark's CPU tests: the harness, its counters and the reference
against the port at tiny sizes. Run them from the root of the checkout:

    python -m pytest benchmark/tests -q

Tests that need a CUDA card carry the `card` marker and skip here; the
`card` fixture decides, when the test runs, whether there is one.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control's readings are taken on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
