"""Milliseconds of wall an audio second in the feature decode
(codec/codec.py::decode, models/frame_predictor.py::decoder):
decode_file's own phase seconds (feature_decode), taken with
`timings=` in a traced run, over the audio seconds of its calls."""

KEYS = ("feature_decode",)


def read(rec):
    if not rec.phases or not rec.counters.get("audio_s"):
        return None
    return 1e3 * sum(rec.phases.get(k, 0.0) for k in KEYS) \
        / rec.counters["audio_s"]
