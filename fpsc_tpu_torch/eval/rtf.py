"""Real-time-factor benchmark harness.

Port of fpsc_tpu/eval/rtf.py:17-35.  CUDA calls return before the card
finishes, so `measure` synchronises the card after each call (when this
process has initialised CUDA) inside the timed region; it reports the
min, median and max host wall over reps.
"""
from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from fpsc_tpu_torch.dsp import constants as C


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn: Callable[[], object], reps: int = 5,
            warmup: int = 1) -> Dict[str, float]:
    for _ in range(warmup):
        fn()
        _sync()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"min_s": times[0], "median_s": times[len(times) // 2],
            "max_s": times[-1]}


def synthesis_rtf(batch: int, n_samples: int, wall_seconds: float,
                  sr: int = C.SAMPLE_RATE) -> float:
    """Aggregate real-time factor: audio-seconds produced per
    wall-second per card."""
    return batch * n_samples / sr / wall_seconds
