"""Fixtures of the benchmark's CPU tests (helpers.py), the card marker."""
import pytest

from wgbs_bench import cache
from wgbs_bench.tests.helpers import make_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, at run
    time, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return torch.device("cuda:0")


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """The tiny checkout's root, with the cache under tmp_path."""
    monkeypatch.setattr(cache, "ROOT", str(tmp_path / "cache"))
    return make_root(str(tmp_path / "checkout"))
