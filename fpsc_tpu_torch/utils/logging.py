"""Structured metrics logging, profiler tracing and NaN debugging.

Port of fpsc_tpu/utils/logging.py:17-55: the append-only JSONL metrics
stream beside the reference-format epoch lines, `torch.profiler` in
place of jax.profiler, and autograd's anomaly mode in place of
jax_debug_nans.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics stream: one record a call, with `step`,
    `time` and the metrics."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        if enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **metrics):
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _device_events(prof) -> int:
    """The count of device (CUDA) events a finished profile recorded."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace a block with torch.profiler: the CPU, and the card when this
    process has initialised CUDA.  The trace is a Chrome-trace JSON
    under log_dir (torch.profiler.tensorboard_trace_handler; chrome://
    tracing or Perfetto read it, TensorBoard is not needed).  Does
    nothing when log_dir is falsy.  On the card, a trace that holds no
    device activity raises: the profiler did not see the card, and an
    idle share read from it would be wrong.  Yields the profiler (None
    when off), whose key_averages() sum the block's kernels."""
    if not log_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    with prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    if on_card and not _device_events(prof):
        raise RuntimeError(
            f"the profile under {log_dir} holds no CUDA activity: the "
            "profiler did not trace the card")


def enable_nan_debugging(enable: bool = True):
    """Fail fast on NaNs: autograd's anomaly mode, which raises where a
    backward function returns NaN and names the forward operation that
    made it.  It checks the backward pass only; JAX's jax_debug_nans
    checks every jitted computation, forward included."""
    torch.autograd.set_detect_anomaly(enable)
