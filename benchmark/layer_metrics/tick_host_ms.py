"""Milliseconds of a tick's wall in which the card did nothing of the
tick (codec/streaming.py's host side: staging the uniforms and PCM,
pinned copies, unpacking the row): the traced ticks' summed wall less
the device's busy time in them, over their count."""


def read(rec):
    ticks = [s for s in rec.of("tick") if s.attrs["traced"]]
    if not rec.traces or not ticks:
        return None
    busy = sum(t.busy_s for t in rec.traces)
    return 1e3 * (sum(s.s for s in ticks) - busy) / len(ticks)
