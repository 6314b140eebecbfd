"""The whole duplex tick's share of the card's float32 peak (the ticks
run with TF32 off), in percent: the model's FLOPs of a tick a stream
(counts/model.py: the analysis, the encoder, the decoder and LPCNet's
published complexity, from the widths) times the streams and the ticks
the profiler did not trace, over those ticks' wall and the peak
(core/peaks.py)."""
from benchmark.core import peaks
from benchmark.counts import model


def read(rec):
    ticks = [s for s in rec.of("tick") if not s.attrs["traced"]]
    if not rec.traced or not ticks:
        return None
    flops = model.stream_tick_flops(rec.config) * rec.counters["streams"]
    return 100.0 * flops * len(ticks) / (sum(s.s for s in ticks)
                                         * peaks.FLOPS["float32"])
