"""Polyphase rational resampling for the encoder's wav reader.

Port of fpsc_tpu/eval/stoi.py:40-70 (`_kaiser_lowpass`,
`resample_poly`), numpy float64; the STOI measure itself is not ported
yet.
"""
from __future__ import annotations

import numpy as np


def _kaiser_lowpass(up: int, down: int, ntaps_per_phase: int = 10,
                    beta: float = 5.0) -> np.ndarray:
    """Windowed-sinc low-pass for polyphase resampling: cutoff at the
    tighter of the two Nyquists, Kaiser window, unity passband gain
    after zero-stuffing."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate          # fraction of the upsampled Nyquist
    half = ntaps_per_phase * max_rate
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    win = np.i0(beta * np.sqrt(np.clip(
        1.0 - (n / half) ** 2, 0.0, 1.0))) / np.i0(beta)
    taps = taps * win
    return taps / taps.sum() * up


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase rational resampling with group-delay compensation;
    len(out) = ceil(len(x) * up / down), scipy.signal.resample_poly's
    geometry."""
    x = np.asarray(x, np.float64)
    h = _kaiser_lowpass(up, down)
    half = (len(h) - 1) // 2
    up_len = len(x) * up
    y = np.zeros(up_len + len(h) - 1, np.float64)
    # zero-stuffed convolution: y[k*up + j] += x[k] * h[j]
    for phase in range(len(h)):
        y[phase:phase + up_len:up] += x * h[phase]
    y = y[half:half + up_len]        # compensate filter delay
    out_len = -(-len(x) * up // down)
    return y[::down][:out_len]
