"""The reader `sampler_launches_per_wait`, on a record and program spans
made up here, and on a CPU run of the decode driver with the program
itself."""
import importlib.util

from bench_helpers import BENCH, drive, load, tiny_decode
from benchmark.core import program_spans
from benchmark.core.record import Record, Span

NS = 1e9


def read(rec, program=None):
    spec = importlib.util.spec_from_file_location(
        "bench_test_sampler_launches_per_wait",
        BENCH / "layer_metrics" / "sampler_launches_per_wait.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec, program)


class P:
    """A program span: nanoseconds, as the program stamps them."""

    def __init__(self, name, t0, t1, **attrs):
        self.name, self.attrs = name, attrs
        self.t0, self.t1 = round(t0 * NS), round(t1 * NS)


def _waits_record():
    """Two calls: the mixed shape, four batch-1 launches on four streams
    under one sampler phase; then the bulk shape, one launch."""
    rec = Record({"name": "t", "chips": 1}, {"vocoder": {"bunch": 2}}, {},
                 True)
    rec.spans = [Span("decode_file", 20.0, 21.0, {"traced": False}),
                 Span("decode_file", 21.0, 22.0, {"traced": False})]
    mixed = [P("sampler.launch", 20.5 + 0.01 * k, 20.505 + 0.01 * k,
               batch=1, frames=f, bunch=2, steps=f * 80, stream=k)
             for k, f in enumerate((1200, 600, 3000, 450))]
    spans = mixed + [P("decode.sampler", 20.4, 20.9, launches=4),
                     P("sampler.launch", 21.5, 21.6, batch=64, frames=400,
                       bunch=2, steps=32000, stream=0),
                     P("decode.sampler", 21.4, 21.9, launches=1),
                     P("decode.sampler", 19.0, 19.5, launches=9)]  # before
    return rec, (spans, 0)


def test_it_reads_each_phases_launches():
    """(4 + 1) / 2 waits: each phase's own count, not the steps of the
    launches under it, so launches side by side count once each."""
    rec, program = _waits_record()
    assert read(rec, program) == 2.5
    spans, _ = program
    mixed = [s for s in spans if 20e9 <= s.t0 < 21e9]
    assert read(rec, (mixed, 0)) == 4.0


def test_it_reads_nothing_without_the_count():
    """A program that launches and waits bucket by bucket records its
    sampler phases without `launches`."""
    rec, (spans, _) = _waits_record()
    for s in spans:
        s.attrs.pop("launches", None)
    assert read(rec, (spans, 0)) is None
    assert read(rec, ([], 0)) is None


def test_a_ring_that_dropped_spans_in_the_window_reads_nothing():
    rec, (spans, _) = _waits_record()
    inside = sorted(spans, key=lambda s: s.t1)
    assert read(rec, (inside, 0)) is not None
    # the spans dropped ended before the oldest kept, inside the window
    kept = [s for s in inside if s.t1 * 1e-9 > min(x.t0 for x in rec.spans)]
    assert read(rec, (kept[1:], 5)) is None
    # spans dropped before the window leave the reading as it was
    early = [P("before", 1.0, 2.0)] + inside
    assert read(rec, (early, 5)) == read(rec, (inside, 0))


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    rec, _ = _waits_record()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert read(rec) is None


def test_it_reads_one_launch_a_wait_on_a_cpu_run_of_the_program(tmp_path):
    """The decode driver at two utterances of one length a call: one
    bucket, so one launch before each call's one wait."""
    from benchmark.drivers import decode
    rec = drive(decode, load("configs/lpcnet_b2_sparse.json"),
                tiny_decode(), load("limits/b2_bulk_decode.json"),
                tmp=tmp_path)
    assert read(rec) == 1.0
