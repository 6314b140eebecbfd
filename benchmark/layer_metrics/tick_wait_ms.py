"""Milliseconds a tick of waiting for the card (codec/ticks.py::
TickRunner: the event's synchronize after the launch): the program's
`tick.wait` inside each of the window's ticks that the profiler did not
trace; the median over those ticks."""
from benchmark.core import program_spans


def read(rec, program=None):
    return program_spans.tick_ms(rec, ("tick.wait",), program)
