"""Tests of the benchmark harness: on the CPU at small sizes; those marked
``cuda`` run on a card and skip without one (``pytest benchmark/tests`` on
the card runs them).

Whether a card is present is decided inside the ``cuda_device`` fixture,
never while a module is imported."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written kernels "
        "have no CPU mode); skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def flagship():
    """The flagship checkpoint's path and its configuration's settings."""
    import json

    cfg = json.loads((BENCH / "configs" / "noiseflow-sax4gax4-exact-f32.json").read_text())
    return dict(cfg, weights_path=str(ROOT / cfg["weights"]))
