"""pytest settings of the benchmark's own tests: its folder and the
program's sources importable, and the ``card`` marker for the tests that
need a CUDA card (they are run on the card with
``python -m pytest faasbench -m card``)."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.join(os.path.dirname(HERE), "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: "
                    "python -m pytest faasbench -m card)")
    return torch.device("cuda", 0)
