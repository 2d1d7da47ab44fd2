"""The benchmark's own tests: the harness, the plain reference, the
checks' control and faults, and the no-JAX rule.

Run them from the checkout's root with `python -m pytest benchmark/tests
-q` (the repository's `pytest tests/` does not collect them).  Tests
that need the card carry the `card` marker and ask for the `card`
fixture, which skips where there is none: the look is made in the
fixture, never while a module is imported.
"""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
