"""Device trace of a stretch of the window, and its reduction.

`traced` runs a block under `torch.profiler` (CPU and CUDA activity),
with a `bench.window` annotation around it whose end waits for the card;
`read`, once the measured window has closed, exports the Chrome trace,
reads it and deletes it.  `summarize` reduces the events to what the
readers take: the traced wall, the union of the kernels' and copies'
intervals inside it (the device's busy time), the kernels' summed time
and count by name, and the idle gaps between the busy intervals, each
labelled by the innermost host event open when the gap began (an
operation of the program, else a benchmark span).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    """The reduced trace: seconds throughout."""

    def __init__(self, window_s: float, busy_s: float,
                 kernels: Dict[str, Tuple[float, int]],
                 gaps: Dict[str, Tuple[float, int]]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels        # name -> (seconds, count)
        self.gaps = gaps              # host label -> (idle seconds, gaps)

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """Summed seconds and count of the kernels whose name holds
        `part`."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:120], s] for k, (s, _) in ops],
                "idle_gaps": [[f"{k[:100]} ({n} gaps)", s]
                              for k, (s, n) in gaps]}


def union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Merged intervals clipped to [lo, hi], in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[dict]) -> Trace:
    """Reduce Chrome-trace events (microseconds) to a Trace."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and "dur" in e]
    kernels: Dict[str, Tuple[float, int]] = {}
    for e in device:
        if e["cat"] == "kernel":
            s, n = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (s + float(e["dur"]) * 1e-6, n + 1)
    busy = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in device], w0, w1)

    def host(cat):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                       e["name"]) for e in events
                      if e.get("cat") == cat and e.get("name") != WINDOW)

    ops, spans = host("cpu_op"), host("user_annotation")
    starts = [a for a, _, _ in ops]
    gaps: Dict[str, Tuple[float, int]] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = (_open_at(ops, starts, g0) or _open_at(spans, None, g0)
                 or "no host event")
        s, n = gaps.get(label, (0.0, 0))
        gaps[label] = (s + (g1 - g0) * 1e-6, n + 1)
    return Trace((w1 - w0) * 1e-6, sum(b - a for a, b in busy) * 1e-6,
                 kernels, gaps)


def _open_at(host, starts, t: float, depth: int = 64) -> Optional[str]:
    """The innermost (latest begun) host event open at t; with `starts`
    (the events' sorted starts) only among the `depth` latest begun
    before t, else among all."""
    i = bisect.bisect_right(starts, t) if starts is not None else len(host)
    lo = max(0, i - depth) if starts is not None else 0
    for a, b, name in reversed(host[lo:i]):
        if a <= t <= b:
            return name
    return None


@contextlib.contextmanager
def traced(profiles: list):
    """Profile the block; the stopped profiler goes to `profiles`, to be
    read by `read` once the window has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    with prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    profiles.append(prof)


def read(prof, work_dir: str) -> Trace:
    """The Trace of a stopped profiler, through its Chrome trace (written
    under work_dir and deleted)."""
    path = os.path.join(work_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)
