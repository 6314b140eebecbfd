"""Structured metrics logging, profiler tracing, spans and NaN debugging.

Port of fpsc_tpu/utils/logging.py:17-55: the append-only JSONL metrics
stream beside the reference-format epoch lines, `torch.profiler` in
place of jax.profiler, and autograd's anomaly mode in place of
jax_debug_nans.

Spans are the program's own record of where its host time goes: a
named interval on the host clock (`time.perf_counter_ns`, the clock of
`time.perf_counter`), with an id, the id of the span open around it on
its thread (0 at the top) and attributes (counts and shapes, never
tensors).  Finished spans go to a ring of the last SPAN_RING, with a
count of those pushed out of it: `spans()` reads the ring,
`dropped_spans()` the count, `clear_spans()` empties both, and
`record_spans(False)` stops the recording (a span still reads the clock
then, so that `span.seconds` holds).  While a torch.profiler records,
each span also opens the annotation "fpsc.<name>"
(`record_function`), so that the spans lie on the kernels' own timeline
in its trace.  No span is opened inside a function that a CUDA graph
captures.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


SPAN_RING = 65536

_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_dropped = 0
_recording = True
_ids = itertools.count(1)
_open = threading.local()           # .ids: the open spans' ids, innermost last


class span:
    """A span around a block:

        with span("decode.unpack", utterances=n) as s:
            ...
            s.attrs["bytes"] = size

    `begin(t0)` and `end(t1)` (nanoseconds of perf_counter_ns) open and
    close it at a clock reading the caller took, for spans that follow
    one another without a gap.  Attributes may be added until it ends."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "t1", "_note")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.t0 = self.t1 = 0
        self._note = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def begin(self, t0: int) -> None:
        self.t0 = t0
        if not _recording:
            return
        ids = getattr(_open, "ids", None)
        if ids is None:
            ids = _open.ids = []
        self.id = next(_ids)
        self.parent = ids[-1] if ids else 0
        ids.append(self.id)
        if _autograd_profiler._is_profiler_enabled:
            self._note = _autograd_profiler.record_function(
                "fpsc." + self.name)
            self._note.__enter__()

    def end(self, t1: int) -> None:
        global _dropped
        self.t1 = t1
        if self._note is not None:
            self._note.__exit__(None, None, None)
            self._note = None
        if not self.id:
            return
        _open.ids.remove(self.id)
        if len(_ring) == SPAN_RING:
            _dropped += 1
        _ring.append(self)

    def __enter__(self) -> "span":
        self.begin(time.perf_counter_ns())
        return self

    def __exit__(self, *exc) -> None:
        self.end(time.perf_counter_ns())


def spans() -> List[span]:
    """The finished spans in the ring, in the order they ended."""
    return list(_ring)


def dropped_spans() -> int:
    """Spans pushed out of the ring (the oldest go first) since the last
    `clear_spans()`."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    _ring.clear()
    _dropped = 0


def record_spans(on: bool = True) -> bool:
    """Turn the recording of spans on or off -> whether it was on."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


def enable_nan_debugging(enable: bool = True):
    """Fail fast on NaNs: autograd's anomaly mode, which raises where a
    backward function returns NaN and names the forward operation that
    made it.  It checks the backward pass only; JAX's jax_debug_nans
    checks every jitted computation, forward included."""
    torch.autograd.set_detect_anomaly(enable)
