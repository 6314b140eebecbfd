"""Kernels a tick: the kernels of the traced ticks (graph nodes
included), over their count.  A count, not a time."""


def read(rec):
    n = len([s for s in rec.of("tick") if s.attrs["traced"]])
    if not rec.traces or not n:
        return None
    return sum(c for t in rec.traces for _, c in t.kernels.values()) / n
