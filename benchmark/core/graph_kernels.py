"""The kernels that replays of captured CUDA graphs launched inside a
program span, from the profiler's Chrome trace.

A kernel of a replayed graph carries, in its `correlation`, the id of
the `cudaGraphLaunch` that launched it; a launch belongs to a span when
the host called it inside the span's annotation (`fpsc.<name>`, which
the program's spans open while a profiler records).  Kernels launched
one by one (copies in and out, products between replays) are not
counted.
"""
from __future__ import annotations

from typing import Dict, List

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAMES = ("cudaGraphLaunch", "cuGraphLaunch")


def launched(events: List[dict], annotation: str) -> Dict[str, float]:
    """{graph_launches, kernels, kernel_s} of the graphs launched inside
    every annotation named `annotation`."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == annotation]
    launches = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS and str(e.get("name", "")).startswith(
                LAUNCH_NAMES):
            ts = float(e["ts"])
            if any(a <= ts <= b for a, b in spans):
                launches.add(e.get("args", {}).get("correlation"))
    launches.discard(None)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e
               and e.get("args", {}).get("correlation") in launches]
    return {"graph_launches": len(launches), "kernels": len(kernels),
            "kernel_s": sum(float(e["dur"]) for e in kernels) * 1e-6}


def replayed(rec, span: str, key: str, program=None):
    """The program's spans named `span` inside the traced decode_file
    calls, each of which replayed a graph (`graph`), with the graphs'
    kernels that the driver read from the trace into rec.lists[key] ->
    (spans, {graph_launches, kernels, kernel_s}); None where the program
    records no such span, or where the trace holds another number of
    graph launches than the spans' `replays`."""
    from benchmark.core import program_spans
    got = program_spans.inside(rec, "decode_file", program,
                               keep=lambda s: s.attrs["traced"])
    spans = [s for _, inner in got or () for s in inner if s.name == span]
    read = rec.lists.get(key)
    if not spans or not read or not all(s.attrs.get("graph")
                                        for s in spans):
        return None
    total = {k: sum(r[k] for r in read) for k in read[0]}
    if total["graph_launches"] != sum(s.attrs["replays"] for s in spans) \
            or total["kernel_s"] <= 0:
        return None
    return spans, total
