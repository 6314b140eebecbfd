"""Histogram / codebook-usage entropy metrics.

A copy of fpsc_tpu/dsp/entropy.py:12-28 (host numpy): the reference's
128-bin histogram entropy in nats over (0, 1) (src/utils.py:117-123)
and the codebook usage entropy in bits
(src/generate_qtz_features.py:94-101).
"""
from __future__ import annotations

import numpy as np


def histogram_entropy(x, bins: int = 128, value_range=(0.0, 1.0)) -> float:
    """Entropy (nats) of the 128-bin density histogram, rounded to 3 dp."""
    x = np.asarray(x).reshape(-1)
    weights, _ = np.histogram(x, bins=bins, range=value_range, density=True)
    prob = weights / np.sum(weights)
    out = -np.sum(prob * np.log(prob + 1e-20))
    return round(float(out), 3)


def usage_entropy_bits(counts) -> float:
    """Empirical entropy (bits) of a codebook usage histogram."""
    counts = np.asarray(counts, dtype=np.float64)
    total = np.sum(counts)
    if total == 0:
        return 0.0
    p = counts / total
    return float(np.sum(-p * np.log2(p + 1e-20)))
