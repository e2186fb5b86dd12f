"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root. Tests that need a CUDA card carry the ``cuda`` marker and
decide inside a fixture whether one is visible."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
