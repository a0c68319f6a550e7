"""pytest settings of the benchmark's own tests: the ``card`` marker for the
tests that need a CUDA card, and the fixture that decides, when a test runs,
whether there is one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the H100; skips here)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's cells run on the H100")
    return torch.device("cuda:0")
