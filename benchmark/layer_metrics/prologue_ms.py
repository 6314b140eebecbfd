"""Milliseconds of wall an audio second in the LPC and the
sampler's prologue (dsp/ceps2lpc.py, ops/lpcnet_sampler.py::prepare):
decode_file's own phase seconds (ceps2lpc, prologue), taken with
`timings=` in a traced run, over the audio seconds of its calls."""

KEYS = ("ceps2lpc", "prologue",)


def read(rec):
    if not rec.phases or not rec.counters.get("audio_s"):
        return None
    return 1e3 * sum(rec.phases.get(k, 0.0) for k in KEYS) \
        / rec.counters["audio_s"]
