"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from the
root of the repo (the repo's own `pytest tests/` does not collect them)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test asks for it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")
