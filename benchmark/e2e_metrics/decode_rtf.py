"""Seconds of audio of every decode_file call completed, over the wall
from the window's start to the end of the last call begun in it."""


def read(rec):
    calls = rec.of("decode_file")
    if not calls:
        return None
    return sum(s.attrs["audio_s"] for s in calls) / (calls[-1].t1
                                                     - calls[0].t0)
