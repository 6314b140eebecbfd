"""Kernels a sample step of the WaveNet's replayed generation: the
kernels that the replays of the program's `wavenet.generate` launched
inside the traced call (core/graph_kernels.py), over the steps of those
replays (`replays` x `chunk`).  A count, not a time: the one a fusion of
the step's kernels would cut."""
from benchmark.core import graph_kernels


def read(rec, program=None):
    got = graph_kernels.replayed(rec, "wavenet.generate", "wavenet_replays",
                                 program)
    if got is None:
        return None
    spans, total = got
    return total["kernels"] / sum(s.attrs["replays"] * s.attrs["chunk"]
                                  for s in spans)
