"""Milliseconds of wall an audio second in the wav writes
(codec/cli.py::save_wav):
decode_file's own phase seconds (write), taken with
`timings=` in a traced run, over the audio seconds of its calls."""

KEYS = ("write",)


def read(rec):
    if not rec.phases or not rec.counters.get("audio_s"):
        return None
    return 1e3 * sum(rec.phases.get(k, 0.0) for k in KEYS) \
        / rec.counters["audio_s"]
