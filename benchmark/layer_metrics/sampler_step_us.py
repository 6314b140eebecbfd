"""Microseconds of the sampler kernel (csrc/lpcnet_sampler.cu's
sample_kernel) a GRU step: its device time in the traces over the GRU
steps (`steps`, frames * 160 / bunch) of the program's own
`sampler.launch` spans begun inside the traced decode_file calls.
Nothing where the traces hold another number of sampler kernels than
those spans, or where the program records none."""
from benchmark.core import program_spans


def read(rec, program=None):
    got = program_spans.inside(rec, "decode_file", program,
                               keep=lambda s: s.attrs["traced"])
    launches = [s for _, inner in got or () for s in inner
                if s.name == "sampler.launch"]
    if not rec.traces or not launches:
        return None
    hits = [t.kernel_s("sample_kernel") for t in rec.traces]
    s, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
    if n != len(launches) or s <= 0:
        return None
    return s / sum(x.attrs["steps"] for x in launches) * 1e6
