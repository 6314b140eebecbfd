"""The readers of the program's own spans, on a record and program spans
made up here, and on CPU runs of the drivers with the program itself;
and the trace's gap labels under the program's annotations."""
import importlib.util

import pytest

from bench_helpers import BENCH, drive, load, tiny_decode, tiny_live
from benchmark.core import program_spans, trace
from benchmark.core.record import Record, Span

NS = 1e9


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"bench_test_{name}", BENCH / "layer_metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class P:
    """A program span: nanoseconds, as the program stamps them."""

    def __init__(self, name, t0, t1, **attrs):
        self.name, self.attrs = name, attrs
        self.t0, self.t1 = round(t0 * NS), round(t1 * NS)


class FakeTrace:
    def __init__(self, sample_s, n):
        self.kernels = {"void sample_kernel<bf16>": (sample_s, n)}

    def kernel_s(self, part):
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


def _record(spans, traced=True):
    rec = Record({"name": "t", "chips": 1}, {"vocoder": {"bunch": 2}}, {},
                 traced)
    rec.spans = spans
    return rec


def _decode_record():
    """Three calls, the middle two traced; each holds one launch a
    bucket: (64, 400) in the bulk shape, then two of batch 1."""
    calls = [Span("decode_file", 10.0, 11.0, {"traced": False}),
             Span("decode_file", 11.0, 12.0, {"traced": True}),
             Span("decode_file", 12.0, 13.0, {"traced": True}),
             Span("decode_file", 13.0, 14.0, {"traced": False})]
    launches = [P("sampler.launch", 10.5, 10.6, batch=64, frames=400,
                  bunch=2, steps=32000),
                P("sampler.launch", 11.5, 11.6, batch=64, frames=400,
                  bunch=2, steps=32000),
                P("sampler.launch", 12.2, 12.3, batch=1, frames=1200,
                  bunch=2, steps=96000),
                P("sampler.launch", 12.5, 12.6, batch=1, frames=600,
                  bunch=2, steps=48000),
                P("sampler.launch", 13.5, 13.6, batch=64, frames=400,
                  bunch=2, steps=32000)]
    others = [P("decode", 11.01, 11.99), P("decode.sampler", 11.4, 11.7),
              P("sampler.launch", 9.0, 9.1, batch=8, frames=10, bunch=2,
                steps=800)]                          # before the window
    rec = _record(calls)
    rec.traces = [FakeTrace(0.176 * 3, 3)]
    rec.lists["traced_launches"] = [(64, 400), (1, 1200), (1, 600)]
    return rec, (others + launches, 0)


def test_sampler_step_us_divides_by_the_programs_own_steps():
    rec, program = _decode_record()
    got = reader("sampler_step_us")(rec, program)
    assert got == pytest.approx(0.176 * 3 / (32000 + 96000 + 48000) * 1e6)
    # the inferred launches of the benchmark count the same steps
    assert got == pytest.approx(reader("sampler_us_per_step")(rec))


def test_sampler_step_us_reads_nothing_where_the_counts_differ():
    rec, program = _decode_record()
    rec.traces = [FakeTrace(0.5, 4)]
    assert reader("sampler_step_us")(rec, program) is None
    rec.traces = []
    assert reader("sampler_step_us")(rec, program) is None


def test_sampler_batch_weights_each_launch_by_its_steps():
    rec, program = _decode_record()
    steps = [32000, 32000, 96000, 48000, 32000]
    batch = [64, 64, 1, 1, 64]
    assert reader("sampler_batch")(rec, program) == pytest.approx(
        sum(b * s for b, s in zip(batch, steps)) / sum(steps))


def _tick_record():
    """Four ticks of 55 ms, the second traced; each holds the program's
    tick with its four children."""
    ticks, spans = [], []
    parts = (("tick.stage", 0.4), ("tick.launch", 2.0), ("tick.wait", 36.0),
             ("tick.unpack", 0.3))
    for k in range(4):
        t0 = 100.0 + 0.06 * k
        ticks.append(Span("tick", t0, t0 + 0.055, {"traced": k == 1}))
        scale = 1.0 + 0.1 * k                  # every tick a little longer
        t = t0 + 0.0001
        kids = []
        for name, ms in parts:
            kids.append(P(name, t, t + ms * scale / 1e3))
            t += ms * scale / 1e3
        spans += kids + [P("tick", t0 + 0.00005, t, cls="StreamingCodec",
                           batch=512, graph=True)]
    return _record(ticks), (spans, 0)


@pytest.mark.parametrize("name, parts", [
    ("tick_stage_ms", (0.4, 0.3)), ("tick_launch_ms", (2.0,)),
    ("tick_wait_ms", (36.0,))])
def test_tick_readers_take_the_median_of_the_untraced_ticks(name, parts):
    rec, program = _tick_record()
    # untraced ticks 0, 2, 3 scale by 1.0, 1.2, 1.3: the median is 1.2
    assert reader(name)(rec, program) == pytest.approx(sum(parts) * 1.2)


def test_tick_readers_read_nothing_without_their_span():
    rec, (spans, _) = _tick_record()
    program = ([s for s in spans if s.name != "tick.wait"], 0)
    assert reader("tick_wait_ms")(rec, program) is None
    assert reader("tick_launch_ms")(rec, program) == pytest.approx(2.4)


@pytest.mark.parametrize("name", ["sampler_step_us", "sampler_batch",
                                  "tick_stage_ms", "tick_launch_ms",
                                  "tick_wait_ms"])
def test_a_ring_that_dropped_spans_in_the_window_reads_nothing(name):
    rec, (spans, _) = (_decode_record() if name.startswith("sampler")
                       else _tick_record())
    inside = sorted(spans, key=lambda s: s.t1)
    assert reader(name)(rec, (inside, 0)) is not None
    # the spans dropped ended before the oldest kept, inside the window
    kept = [s for s in inside if s.t1 * 1e-9 > min(x.t0 for x in rec.spans)]
    assert reader(name)(rec, (kept[1:], 5)) is None
    # spans dropped before the window leave the readings as they were
    early = [P("before", 1.0, 2.0)] + inside
    assert reader(name)(rec, (early, 5)) == reader(name)(rec, (inside, 0))


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    rec, _ = _decode_record()
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    for name in ("sampler_step_us", "sampler_batch"):
        assert reader(name)(rec) is None
    rec, _ = _tick_record()
    for name in ("tick_stage_ms", "tick_launch_ms", "tick_wait_ms"):
        assert reader(name)(rec) is None


def test_the_readers_on_cpu_runs_of_the_program(tmp_path):
    """The decode driver at two utterances a call: one launch of batch 2
    a call; the live driver: the stage, launch and unpack of each tick,
    and no wait on the CPU."""
    from benchmark.drivers import decode, live
    rec = drive(decode, load("configs/lpcnet_b2_sparse.json"),
                tiny_decode(), load("limits/b2_bulk_decode.json"),
                tmp=tmp_path)
    assert reader("sampler_batch")(rec) == 2.0
    got = program_spans.inside(rec, "decode_file")
    assert all(sum(s.name == "sampler.launch" for s in inner) == 1
               for _, inner in got)
    rec = drive(live, load("configs/lpcnet_b1.json"), tiny_live(),
                load("limits/b1_live_calls.json"), tmp=tmp_path)
    stage = reader("tick_stage_ms")(rec)
    launch = reader("tick_launch_ms")(rec)
    assert stage > 0 and launch > 0
    assert reader("tick_wait_ms")(rec) is None
    walls = sorted(s.s * 1e3 for s in rec.of("tick"))
    assert stage + launch <= walls[len(walls) // 2] * 1.5


def test_a_gap_under_a_program_annotation_carries_its_name():
    """An idle gap that begins while only annotations are open takes the
    innermost: the program's, inside the benchmark's."""
    def ann(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts,
                "dur": dur}

    def kernel(ts, dur):
        return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur}

    events = [ann(trace.WINDOW, 0, 1000), ann("bench.decode_file", 10, 980),
              ann("fpsc.decode", 20, 960), ann("fpsc.decode.sampler", 30, 300),
              ann("fpsc.decode.write", 600, 300),
              {"cat": "cpu_op", "name": "aten::copy_", "ts": 350, "dur": 100},
              kernel(0, 100), kernel(300, 50), kernel(620, 10),
              kernel(950, 50)]
    got = trace.summarize(events)
    assert got.gaps == {
        "fpsc.decode.sampler": (pytest.approx(200e-6), 1),
        "aten::copy_": (pytest.approx(270e-6), 1),
        "fpsc.decode.write": (pytest.approx(320e-6), 1)}
