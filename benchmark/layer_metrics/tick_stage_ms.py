"""Milliseconds a tick of the streaming class's host work around the
replay (codec/streaming.py): the program's `tick.stage` (the uniforms
and rows into the pinned buffers) and `tick.unpack` (the row's copy and
split) inside each of the window's ticks that the profiler did not
trace, summed a tick; the median over those ticks."""
from benchmark.core import program_spans


def read(rec, program=None):
    return program_spans.tick_ms(rec, ("tick.stage", "tick.unpack"),
                                 program)
