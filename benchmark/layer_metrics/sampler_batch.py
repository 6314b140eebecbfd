"""Items a sampler launch, weighted by its GRU steps: the `batch` of
the program's own `sampler.launch` spans inside the window's
decode_file calls, each counted by its `steps`.  A bucketing change
shows here as it changes the launches the program makes."""
from benchmark.core import program_spans


def read(rec, program=None):
    got = program_spans.inside(rec, "decode_file", program)
    launches = [s for _, inner in got or () for s in inner
                if s.name == "sampler.launch"]
    steps = sum(s.attrs["steps"] for s in launches)
    if not steps:
        return None
    return sum(s.attrs["batch"] * s.attrs["steps"] for s in launches) / steps
