"""The sampler kernel's share of its roofline: the least time of the
traced launches' folded work (counts/sampler.py, from the
configuration's widths, live blocks and sampler precision) over the
kernel's device time in the trace, in percent.  Nothing where the
trace holds another number of sampler launches than the traced calls'
buckets of equal lengths: the work would then be counted wrong."""
from benchmark.counts import sampler


def read(rec):
    launches = rec.lists.get("traced_launches")
    if not rec.traces or not launches:
        return None
    s, n = rec.traces[0].kernel_s("sample_kernel")
    if n != len(launches) or s <= 0:
        return None
    dtype = rec.config["precision"]["sampler"]
    least = sum(sampler.least_time(rec.config["vocoder"], b, f, dtype)
                for b, f in launches)
    return 100.0 * least / s
