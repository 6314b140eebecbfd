"""The probes' timer and output line.

`median_ms` times a call with CUDA events: one warm-up call, then REPS
timed calls, each between two events on the current stream, and the
median.  Before each timed call a spin kernel (torch.cuda._sleep) holds
the card for about a millisecond while the host enqueues the events and
the call, so that a short kernel is timed on the card, not at the pace
of the wrapper's Python.  The timer refuses a tensor that is not on a
CUDA card: a time taken on the host's CPU is never printed under the
card's name.
"""
from __future__ import annotations

import statistics
from typing import Callable

import torch

REPS = 9
# about 1 ms of an H100's clock
SPIN_CYCLES = 2_000_000


def median_ms(fn: Callable[[], object], like: torch.Tensor,
              reps: int = REPS) -> float:
    """The median time of fn() in ms over `reps` calls after one warm-up,
    on the card that holds `like`."""
    _need_cuda(like.device)
    with torch.cuda.device(like.device):
        fn()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _need_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the probe timer takes CUDA tensors, not {device}")


def card(device: torch.device) -> str:
    """The name of the card the probe runs on; a CPU device is refused."""
    _need_cuda(device)
    return torch.cuda.get_device_name(device)


def line(arm: str, value: float, unit: str, card_name: str,
         extra: str = "") -> str:
    """One arm's result as the scripts print it, with the card's name."""
    return f"{arm:10s}: {value:.3f} {unit}{extra} [{card_name}]"
