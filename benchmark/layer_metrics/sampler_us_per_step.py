"""Microseconds of the sampler kernel (csrc/lpcnet_sampler.cu's
sample_kernel) a GRU step: its device time in the traced calls, over
the GRU steps of their launches (one a bucket of utterances of one
length: frames * 160 / bunch steps, the bucket's items stepping
together).  Nothing where the trace holds another number of sampler
launches than those buckets: the steps would then be counted wrong."""


def read(rec):
    launches = rec.lists.get("traced_launches")
    if not rec.traces or not launches:
        return None
    s, n = rec.traces[0].kernel_s("sample_kernel")
    if n != len(launches):
        return None
    bunch = rec.config["vocoder"]["bunch"]
    steps = sum(frames * 160 // bunch for _, frames in launches)
    return s / steps * 1e6
