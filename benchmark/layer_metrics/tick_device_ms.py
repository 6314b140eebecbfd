"""Milliseconds of device busy time a tick (codec/ticks.py::TickRunner's
replayed graph, its copies in and out): the union of the kernels' and
copies' intervals over the traced ticks, over their count."""


def read(rec):
    n = len([s for s in rec.of("tick") if s.attrs["traced"]])
    if not rec.traces or not n:
        return None
    return 1e3 * sum(t.busy_s for t in rec.traces) / n
