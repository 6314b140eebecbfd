"""Fixtures of the benchmark's own tests.  Run them with

    python -m pytest benchmark/tests

(the repo's `pytest tests/` does not collect them); those marked `cuda`
skip without a card and run on it."""
import pytest

from bench_helpers import load


@pytest.fixture
def b2():
    return load("configs/lpcnet_b2_sparse.json")


@pytest.fixture
def b1():
    return load("configs/lpcnet_b1.json")
