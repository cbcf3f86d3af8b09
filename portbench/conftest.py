"""Test settings of the benchmark's own tests (``portbench/tests``).

Run them from the root of the repository, apart from the repository's own
suite, which configures JAX:

    python -m pytest portbench/tests -q --confcutdir=portbench -p no:cacheprovider

Tests that need a card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is present; whether there is
one is decided there, never while a module is imported.
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of metrics_tpu_torch run on the card only")
    return torch.device("cuda")
