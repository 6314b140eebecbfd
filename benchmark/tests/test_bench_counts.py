"""The yardstick's counts against values worked by hand, and the trace
reader on a canned Chrome trace."""
import pytest

from benchmark.core import trace
from benchmark.core.record import Record, Span
from benchmark.counts import model, sampler


def test_sampler_work_of_the_flagship_by_hand(b2):
    # one item, one frame: 80 GRU steps of bunch 2
    wk = sampler.work(b2["vocoder"], 1, 1, "bfloat16")
    # MACs a step: 22 live 64x64 blocks, GRU_B 3*32*(384+32), two heads
    # of 2*256*32 on h_b
    assert wk["flops"] == 2 * (22 * 4096 + 39936 + 32768) * 80
    # adds: 255 a draw, and 5*3*384 + 2*2*256 gathered rows a step
    assert wk["adds"] == 255 * 160 + 6784 * 80
    assert wk["bytes"] == 3204 + 325632 + 10112 + 4 * 256 * 6784 + 640
    assert sampler.least_time(b2["vocoder"], 1, 1, "bfloat16") \
        == pytest.approx(7286404 / 3.35e12)


def test_sampler_bound_scales_with_batch_and_frames(b2):
    one = sampler.work(b2["vocoder"], 1, 1, "bfloat16")
    big = sampler.work(b2["vocoder"], 64, 400, "bfloat16")
    assert big["flops"] == one["flops"] * 64 * 400
    # weights, biases and tables are read once a call
    fixed = 325632 + 10112 + 4 * 256 * 6784
    assert big["bytes"] - fixed == (one["bytes"] - fixed) * 64 * 400


def test_model_flops_by_hand(b2, b1):
    frame = (3 * 84 * 128 + 3 * 128 * 128 + 2 * 128 * 128
             + 128 * 3 * (384 + 32)) + (3 * 384 * 404 + 3 * 128 * 512
                                        + 128 * 18)
    assert model.frame_macs(b2) == frame
    # the GRUs once a step of two samples, a dual head on h_b a sample;
    # the second head's embedding products are lookups
    sample = (22 * 4096 + 3 * 32 * 416) / 2 + 2 * 32 * 256
    assert model.sample_macs(b2) == sample
    assert model.flops_per_audio_s(b2) == 2 * (100 * frame + 16000 * sample)
    # LPCNet's published count at N_A 384 dense, N_B 16, Q 256, a sample
    assert model.sample_macs(b1) == 3 * 384 ** 2 + 3 * 16 * 400 + 2 * 16 * 256


def test_roofline_reader_stays_a_share(b2):
    from benchmark import run
    read = run.reader("layer_metrics", "sampler_roofline_pct")
    rec = Record({}, b2, {}, True)
    rec.lists["traced_launches"] = [(64, 400)]
    least = sampler.least_time(b2["vocoder"], 64, 400, "bfloat16")
    rec.traces = [trace.Trace(1.0, 0.5, {"sample_kernel<x>": (least * 4, 1)},
                              {})]
    assert read(rec) == pytest.approx(25.0)
    rec.traces = []
    assert read(rec) is None


def test_sampler_readers_want_one_launch_a_bucket(b2):
    """A trace with another number of sampler launches than the traced
    calls' buckets (a change of bucketing) reads nothing."""
    from benchmark import run
    rec = Record({}, b2, {}, True)
    rec.lists["traced_launches"] = [(1, 400), (3, 200)]
    steps = (400 + 200) * 80
    for launches, want in ((2, 13.0), (1, None), (3, None)):
        rec.traces = [trace.Trace(1.0, 0.5, {"sample_kernel<x>": (
            steps * 13e-6, launches)}, {})]
        us = run.reader("layer_metrics", "sampler_us_per_step")(rec)
        pct = run.reader("layer_metrics", "sampler_roofline_pct")(rec)
        assert (us is None) == (want is None) == (pct is None)
        if want is not None:
            assert us == pytest.approx(want)


EVENTS = [
    {"name": "bench.window", "cat": "user_annotation", "ts": 0, "dur": 100},
    {"name": "bench.decode_file", "cat": "user_annotation", "ts": 0,
     "dur": 100},
    {"name": "aten::mm", "cat": "cpu_op", "ts": 0, "dur": 12},
    {"name": "aten::copy_", "cat": "cpu_op", "ts": 40, "dur": 15},
    {"name": "A", "cat": "kernel", "ts": 10, "dur": 20},
    {"name": "B", "cat": "kernel", "ts": 20, "dur": 20},
    {"name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 50, "dur": 10},
    {"name": "A", "cat": "kernel", "ts": 90, "dur": 30},
]


def test_trace_union_gaps_and_sums():
    t = trace.summarize(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # [10, 40] + [50, 60] + [90, 100] clipped to the window
    assert t.busy_s == pytest.approx(50e-6)
    assert t.kernels["A"][0] == pytest.approx(50e-6) and \
        t.kernels["A"][1] == 2
    assert t.kernel_s("B") == (pytest.approx(20e-6), 1)
    assert t.gaps == {"aten::mm": (pytest.approx(10e-6), 1),
                      "aten::copy_": (pytest.approx(10e-6), 1),
                      "bench.decode_file": (pytest.approx(30e-6), 1)}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "A"
    assert b["idle_gaps"][0] == ["bench.decode_file (1 gaps)",
                                 pytest.approx(30e-6)]


def test_union_merges_and_clips():
    assert trace.union([(5, 8), (0, 3), (2, 4), (9, 20)], 1, 10) == \
        [[1, 4], [5, 8], [9, 10]]


def test_end_to_end_readers():
    from benchmark import run
    rec = Record({}, {}, {}, False)
    rec.spans = [Span("decode_file", 0.0, 1.0, {"audio_s": 256.0}),
                 Span("decode_file", 1.0, 2.0, {"audio_s": 256.0})]
    assert run.reader("e2e_metrics", "decode_rtf")(rec) == 256.0
    rec.spans = [Span("tick", i * 0.05, i * 0.05 + (0.04 if i % 10 else
                                                    0.05), {})
                 for i in range(100)]
    rec.counters["streams"] = 512
    assert run.reader("e2e_metrics", "tick_p95_ms")(rec) == \
        pytest.approx(50.0)
    wall = 99 * 0.05 + 0.04
    assert run.reader("e2e_metrics", "stream_capacity")(rec) == \
        pytest.approx(512 * 100 * 0.01 / wall)
