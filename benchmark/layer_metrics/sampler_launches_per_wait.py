"""Sampler launches a wait: the `launches` of the program's own
`decode.sampler` spans inside the window's decode_file calls (the
sampler launches a call put in flight before that phase's one wait),
over the count of those spans.  It counts launches, not the GRU steps
of the `sampler.launch` spans under them, so launches that run side by
side on several streams count once each.  Nothing where no
`decode.sampler` span holds `launches`: a program that waits on each
bucket's launch before the next."""
from benchmark.core import program_spans


def read(rec, program=None):
    got = program_spans.inside(rec, "decode_file", program)
    waits = [s.attrs["launches"] for _, inner in got or () for s in inner
             if s.name == "decode.sampler" and "launches" in s.attrs]
    if not waits:
        return None
    return sum(waits) / len(waits)
