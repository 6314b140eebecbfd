"""Microseconds of the WaveNet's generation a sample step: the device
time of the kernels that the replays of the program's `wavenet.generate`
launched inside the traced call (core/graph_kernels.py), over the
`samples` of those spans.  Nothing where the program records no such
span, or where the trace holds another number of graph launches than
the spans' `replays`."""
from benchmark.core import graph_kernels


def read(rec, program=None):
    got = graph_kernels.replayed(rec, "wavenet.generate", "wavenet_replays",
                                 program)
    if got is None:
        return None
    spans, total = got
    return total["kernel_s"] / sum(s.attrs["samples"] for s in spans) * 1e6
