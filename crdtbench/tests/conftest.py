"""Tests of the benchmark itself.  CPU tests run the program's plain
twins at tiny sizes (``device="cpu"``); tests marked ``cuda`` need the
card and skip elsewhere (decided inside a fixture)."""
from pathlib import Path

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_catchup(cfg, tr):
    cfg["replicas"] = 8
    cfg["ops"] = 8 * 1024
    tr["delta_ops"] = [1024, 1536, 2048, 3072]
    tr["checked_steps"] = 2


TINY = {"rga64x1M.catchup": tiny_catchup}

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.fixture
def root():
    """The checkout's root, whose BENCHMARK.json lists the cells."""
    return ROOT
