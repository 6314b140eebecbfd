"""The whole WaveNet decode's share of the card's float32 peak, in
percent: the model's FLOPs for the audio of the traced run's calls that
the profiler did not trace (counts/wavenet.py: the stack, its
conditioning, the upsampler and the predictor's frame work, from the
widths) over those calls' wall, times the float32 peak
(core/peaks.py)."""
from benchmark.core import peaks
from benchmark.counts import wavenet


def read(rec):
    calls = [s for s in rec.of("decode_file") if not s.attrs["traced"]]
    if not rec.traced or not calls:
        return None
    audio = sum(s.attrs["audio_s"] for s in calls)
    wall = sum(s.s for s in calls)
    return (100.0 * wavenet.flops_per_audio_s(rec.config) * audio
            / (wall * peaks.FLOPS["float32"]))
