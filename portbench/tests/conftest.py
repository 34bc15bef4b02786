"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests -q`` from the root of a checkout).  Tests that need a CUDA
device carry the ``gpu`` marker and take the ``cuda`` fixture, which skips
them where there is none; the question is asked when the test runs, never
while this module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
