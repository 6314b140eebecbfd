"""Pytest settings shared by every test directory: the `cuda` marker.

Tests marked `cuda` need an NVIDIA card (the port's CUDA kernels have no
CPU mode).  They decide inside the test whether a card is present and
skip with a reason where there is none; on the card they run with

    python -m pytest -m cuda tests/test_torch_card.py
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
