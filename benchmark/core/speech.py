"""Speech-like 16 kHz PCM from a seed, for the live streams.

A glottal pulse train at an f0 gliding sinusoidally about `f0_hz` by
+-`f0_swing_hz`, unvoiced stretches of white noise (a share
`unvoiced_share` of each cycle of 1/2.5-1/4 s), three formant resonators
in the given bands, a noise floor, peak 0.9, quantised to 16 bits.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def signal(g: np.random.Generator, n: int, p: Dict) -> np.ndarray:
    from scipy.signal import lfilter
    t = np.arange(n) / 16000.0
    f0 = p["f0_hz"] + p["f0_swing_hz"] * np.sin(
        2 * np.pi * g.uniform(0.5, 1.5) * t + g.uniform(0, 2 * np.pi))
    pulses = np.diff(np.floor(np.cumsum(f0) / 16000.0), prepend=0.0)
    glottal = lfilter([1.0], [1.0, -0.95], pulses)
    voiced = (t * g.uniform(2.5, 4.0) + g.uniform()) % 1.0 \
        >= p["unvoiced_share"]
    y = np.where(voiced, glottal, 0.3 * g.standard_normal(n))
    for lo, hi, bw in p["formants"]:
        r = np.exp(-np.pi * bw / 16000.0)
        theta = 2 * np.pi * g.uniform(lo, hi) / 16000.0
        y = lfilter([1 - r], [1.0, -2 * r * np.cos(theta), r * r], y)
    y = y + 1e-3 * np.abs(y).max() * g.standard_normal(n)
    y = 0.9 * y / np.abs(y).max()
    return (np.round(y * 32767) / 32768.0).astype(np.float32)


def streams(g: np.random.Generator, p: Dict) -> np.ndarray:
    """(streams, ticks, 160) blocks: `signals` distinct signals of
    `signal_ticks` blocks, stream s taking signal s % signals from an
    offset of 37 (s // signals) blocks, cyclically."""
    n, k, ticks = p["streams"], p["signals"], p["signal_ticks"]
    base = np.stack([signal(g, ticks * 160, p["speech"]) for _ in range(k)])
    base = base.reshape(k, ticks, 160)
    out = np.empty((n, ticks, 160), np.float32)
    for s in range(n):
        out[s] = np.roll(base[s % k], -37 * (s // k), axis=0)
    return out
