"""Tests of the benchmark harness, on the CPU at a tiny size.

Run from the root of the checkout: ``python -m pytest obbench/tests``.
Tests marked ``chip`` need a CUDA card and skip without one; the card is
looked for inside the ``card`` fixture, never while a module is
imported.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tiny sizes the CPU tests run at
TINY = {"tpch": {"scale_factor": 0.01},
        "vectors": {"rows": 20_000, "queries": 200}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture()
def tiny(monkeypatch):
    """The harness with every configuration cut to its tiny size."""
    from obbench import harness

    orig = harness.load_config

    def small(name):
        cfg = orig(name)
        cfg.update(TINY[cfg["dataset"]])
        return cfg

    monkeypatch.setattr(harness, "load_config", small)
    return harness
