"""The 95th percentile of the wall of every tick of the window (a
synchronised process_pcm of every stream), in milliseconds; the
quantile by Python's statistics.quantiles (n=20, exclusive)."""
import statistics


def read(rec):
    ticks = rec.of("tick")
    if len(ticks) < 20:
        return None
    return 1e3 * statistics.quantiles([s.s for s in ticks], n=20)[18]
