"""Milliseconds a tick of the host's launch (codec/ticks.py::TickRunner:
the copies in, `graph.replay()`, the copy out, the event's record): the
program's `tick.launch` inside each of the window's ticks that the
profiler did not trace; the median over those ticks."""
from benchmark.core import program_spans


def read(rec, program=None):
    return program_spans.tick_ms(rec, ("tick.launch",), program)
