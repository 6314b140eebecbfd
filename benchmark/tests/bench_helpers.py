"""Shared pieces of the benchmark's own CPU tests."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def load(rel: str):
    return json.loads((BENCH / rel).read_text())


def tiny_decode():
    """A decode traffic small enough for the CPU: 2 utterances of 3
    frames a call, two calls."""
    return {"driver": "decode", "utterances_per_call": 2, "containers": 2,
            "lengths": {"kind": "fixed", "frames": 3}, "traced_calls": 1}


def tiny_live():
    """A live traffic small enough for the CPU: 4 streams, 2 judged."""
    t = load("traffic/live_512.json")
    t.update(streams=4, signals=2, signal_ticks=30, judged_streams=2)
    return t


def drive(driver, cfg, traffic, limits, seconds=1.0, seed=2 ** 31 + 11,
          control=False, tmp=None, device="cpu"):
    """One run of a driver on the program's CPU path (or `device`) -> its
    Record."""
    import time
    from benchmark.core.record import Record
    rec = Record({"name": "test", "chips": 1}, cfg, traffic, False)
    driver.run(rec, seed=seed, seconds=seconds, work=str(tmp),
               limits=limits, t_start=time.perf_counter(),
               log=lambda *a: None, control=control, device=device)
    return rec
