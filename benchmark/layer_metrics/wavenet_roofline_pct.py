"""The WaveNet generation's share of its roofline, in percent: the
least time of the traced steps' work (counts/wavenet.py: each step's
FLOPs at the float32 peak, or its weights read once, the larger, at the
rows its `wavenet.generate` span ran, its batch where the span has no
rows), over the device time of the kernels the replays launched
(core/graph_kernels.py)."""
from benchmark.core import graph_kernels
from benchmark.counts import wavenet


def read(rec, program=None):
    got = graph_kernels.replayed(rec, "wavenet.generate", "wavenet_replays",
                                 program)
    if got is None:
        return None
    spans, total = got
    least = sum(wavenet.least_step_s(
        rec.config, s.attrs.get("rows", s.attrs["batch"]))
        * s.attrs["samples"] for s in spans)
    return 100.0 * least / total["kernel_s"]
