"""What one run records, for the metric readers.

A driver fills a Record: the set-up seconds, the window's calls or
ticks as spans on the host clock (`perf_counter`, the span closed after
the card was synchronised), counters, the program's own phase seconds
(traced runs only), the reduced device traces, and the numbers that
decide `correct`, each beside its limit.  A reader in e2e_metrics/ or
layer_metrics/ takes the Record and returns a number, or None where
it finds nothing to read.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class Span:
    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict):
        self.name, self.t0, self.t1, self.attrs = name, t0, t1, attrs

    @property
    def s(self) -> float:
        return self.t1 - self.t0


class Check:
    """One number compared: it passes at or below `limit`."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"{self.name} {self.value!r} (limit <= {self.limit!r}) "
                f"{'ok' if self.ok else 'FAIL'}")


class Record:
    def __init__(self, cell: dict, config: dict, traffic: dict,
                 trace: bool):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.traced = trace
        self.setup_s: Optional[float] = None
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}
        self.traces: list = []
        self.lists: Dict[str, list] = {}
        self.checks: List[Check] = []
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A span of the benchmark's own around a call into the program;
        in a traced run it also marks the profiler's timeline."""
        if self.traced:
            from torch.profiler import record_function
            ctx = record_function(f"bench.{name}")
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield attrs
        self.spans.append(Span(name, t0, time.perf_counter(), attrs))

    def of(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def add(self, counter: str, value: float) -> None:
        self.counters[counter] = self.counters.get(counter, 0.0) + value
