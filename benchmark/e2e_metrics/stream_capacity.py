"""Live calls one card carries in real time: streams times ticks times
10 ms of audio, over the wall from the first tick's start to the last
tick's end."""


def read(rec):
    ticks = rec.of("tick")
    if not ticks:
        return None
    wall = ticks[-1].t1 - ticks[0].t0
    return rec.counters["streams"] * len(ticks) * 0.01 / wall
