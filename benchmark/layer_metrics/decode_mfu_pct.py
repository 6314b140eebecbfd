"""The whole decode's share of the card's peak, in percent: the model's
FLOPs for the audio of the traced run's calls that the profiler did not
trace (counts/model.py: LPCNet's published complexity and the
frame-rate networks, from the widths) over those calls' wall, times the
peak of the sampler's precision (core/peaks.py)."""
from benchmark.core import peaks
from benchmark.counts import model


def read(rec):
    calls = [s for s in rec.of("decode_file") if not s.attrs["traced"]]
    if not rec.traced or not calls:
        return None
    audio = sum(s.attrs["audio_s"] for s in calls)
    wall = sum(s.s for s in calls)
    peak = peaks.FLOPS[rec.config["precision"]["sampler"]]
    return 100.0 * model.flops_per_audio_s(rec.config) * audio / (wall * peak)
