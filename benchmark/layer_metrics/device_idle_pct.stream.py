"""The device's idle share of the traced ticks, in percent: 100
less the union of the kernels' and copies' intervals over the traced
wall."""


def read(rec):
    window = sum(t.window_s for t in rec.traces)
    if window <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_s for t in rec.traces) / window)
