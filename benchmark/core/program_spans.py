"""The program's own spans (fpsc_tpu_torch/utils/logging.py), read in
process once the window has closed, beside the record's spans.

The program stamps its spans with perf_counter_ns, the clock of the
record's perf_counter: a program span lies inside a span of the record
where it begins and ends within it.  A program without the recorder, or
one whose ring dropped spans that ended in the window, gives nothing.
"""
from __future__ import annotations

import bisect
import statistics
from typing import List, Optional, Tuple


def recorded():
    """(the program's finished spans, the count its ring dropped), or
    None where the program records no spans."""
    try:
        from fpsc_tpu_torch.utils.logging import dropped_spans, spans
    except ImportError:
        return None
    return spans(), dropped_spans()


def inside(rec, outer: str, program=None,
           keep=lambda s: True) -> Optional[List[Tuple[object, list]]]:
    """Each span of the record named `outer` (those `keep` keeps) with
    the program's spans inside it; None where the program records none
    or dropped any that ended in the window."""
    program = recorded() if program is None else program
    if program is None or not rec.spans:
        return None
    spans, dropped = program
    window = min(s.t0 for s in rec.spans)
    # the ring drops the spans that ended first
    if dropped and (not spans or spans[0].t1 * 1e-9 >= window):
        return None
    spans = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in spans]
    out = []
    for o in rec.of(outer):
        if not keep(o):
            continue
        t0, t1 = round(o.t0 * 1e9), round(o.t1 * 1e9)
        lo = bisect.bisect_left(starts, t0)
        hi = bisect.bisect_right(starts, t1)
        out.append((o, [s for s in spans[lo:hi] if s.t1 <= t1]))
    return out


def tick_ms(rec, names, program=None) -> Optional[float]:
    """Milliseconds of the program's spans of `names` a tick: the median,
    over the window's ticks that the profiler did not trace and that hold
    the program's `tick`, of their sum in each; None where no such span
    lies in any."""
    got = inside(rec, "tick", program, keep=lambda s: not s.attrs["traced"])
    if not got:
        return None
    ticks = [inner for _, inner in got
             if any(s.name == "tick" for s in inner)]
    if not any(s.name in names for inner in ticks for s in inner):
        return None
    return statistics.median(
        sum((s.t1 - s.t0) * 1e-6 for s in inner if s.name in names)
        for inner in ticks)
