"""The WaveNet cell's pieces (`wn_bulk_decode`) and the bunch=1 bulk cell
(`b1_bulk_decode`), on the CPU at tiny sizes with the program's CPU
path: the driver through the harness, the counts against the hand
count at the published widths, the reference's independence and its
blocks, the trace's replayed kernels and the readers on a record made
up here, and a sample altered where the vocoder produces it.  The
control (the reference in TF32 in the program's place) needs the card's
TF32 and is marked `cuda`."""
import importlib.util
import json
import subprocess
import sys

import pytest
import torch

from bench_helpers import BENCH, ROOT, drive, load, tiny_decode
from benchmark.core import graph_kernels
from benchmark.core.record import Check, Record, Span
from benchmark.counts import wavenet as counts

NS = 1e9


def reader(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"bench_wn_test_{name.replace('.', '_')}",
        BENCH / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def tiny_wavenet():
    """wavenet_lpc with 2 x 3 layers of 16 / 24 / 16, conditioning 24,
    front 8."""
    cfg = load("configs/wavenet_lpc.json")
    cfg["wavenet"].update(num_blocks=2, num_layers=3, residual_channels=16,
                          gate_channels=24, skip_channels=16,
                          cout_channels=24, front_kernel=8)
    return cfg


def tiny_traffic():
    t = tiny_decode()
    t.update(driver="decode_wavenet", traced={"utterances": 2, "frames": 2})
    return t


def _wn(tmp_path, **kw):
    from benchmark.drivers import decode_wavenet
    return drive(decode_wavenet, tiny_wavenet(), tiny_traffic(),
                 load("limits/wn_bulk_decode.json"), tmp=tmp_path, **kw)


def _failed(rec):
    return sorted(c.name for c in rec.checks if not c.ok)


def test_the_wavenet_driver_runs_through_the_harness(tmp_path):
    """A sound run is correct; its calls are the record's spans; the
    decode readers read its phases, with the WaveNet's in prologue."""
    rec = _wn(tmp_path)
    assert rec.failed == 0 and rec.attempted >= 1
    assert _failed(rec) == []
    assert [c.name for c in rec.checks] == [
        "coded_err", "lpc_err_cond", "eps_err", "wav_file_mismatch"]
    assert reader("e2e_metrics", "decode_rtf")(rec) > 0
    assert reader("e2e_metrics", "setup_s")(rec) > 0
    rec.traced = True
    assert reader("layer_metrics", "wavenet_mfu_pct")(rec) > 0
    from benchmark.core import program_spans
    got = program_spans.inside(rec, "decode_file")
    for _, inner in got:
        names = [s.name for s in inner]
        assert names.count("wavenet.generate") == 1
        assert "decode.wavenet" in names and "decode.sampler" not in names


def test_the_b1_bulk_cell_runs_the_decode_driver(tmp_path):
    """b1_bulk_decode: the decode driver at lpcnet_b1, bunch=1, under its
    own limits."""
    from benchmark.drivers import decode
    rec = drive(decode, load("configs/lpcnet_b1.json"), tiny_decode(),
                load("limits/b1_bulk_decode.json"), tmp=tmp_path)
    assert rec.failed == 0 and _failed(rec) == []
    assert reader("layer_metrics", "sampler_batch")(rec) == 2.0


def test_an_altered_sample_fails_eps_err(tmp_path, monkeypatch):
    """One sample of the generation's output altered by 0.05: the draw
    it implies is off by that over its spread."""
    from fpsc_tpu_torch.models import wavenet as wn
    real = wn.generate

    def generate(*a, **k):
        y = real(*a, **k).clone()
        y[0, 200] += 0.05
        return y

    monkeypatch.setattr(wn, "generate", generate)
    assert _failed(_wn(tmp_path)) == ["eps_err"]


def test_the_state_dropped_between_chunks_fails_eps_err(tmp_path,
                                                       monkeypatch):
    """Generation whose layers lose their past at every chunk's end (the
    rings zeroed): the draws after the first chunk are off."""
    from fpsc_tpu_torch.models import wavenet as wn
    real = wn.GenerateChunks._chunk

    def chunk(self):
        real(self)
        self.rings.zero_()

    monkeypatch.setattr(wn.GenerateChunks, "_chunk", chunk)
    assert _failed(_wn(tmp_path)) == ["eps_err"]


def test_counts_at_the_published_widths_by_hand():
    """A layer: two taps of 128 x 512, the conditioning's 128 x 512, the
    residual and skip 256 x 256; 20 layers, the front 32 x 128, the
    finals 128 x 128 and 128 x 2: 5,263,616 MACs a sample, whose
    matrices are 21.05 MB of float32, and 103,432 B of biases."""
    cfg = load("configs/wavenet_lpc.json")
    layer = 2 * 65536 + 65536 + 65536
    assert counts.sample_macs(cfg) == 20 * layer + 32 * 128 + 128 * 128 \
        + 128 * 2 == 5263616
    weights, biases = counts.step_weights(cfg)
    assert 4 * weights == 21054464
    assert biases == 128 + 20 * (512 + 512 + 128 + 128) + 128 + 2
    assert counts.step_bytes(cfg) == 4 * (5263616 + 25858)
    # 168 GFLOP an audio second; at batch 64 the products bound a step
    assert counts.flops_per_audio_s(cfg) == pytest.approx(168.6e9, rel=1e-3)
    assert counts.least_step_s(cfg, 64) == pytest.approx(
        2 * 5263616 * 64 / 67e12)
    assert counts.least_step_s(cfg, 1) == pytest.approx(
        counts.step_bytes(cfg) / 3.35e12)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.')\n"
         "import benchmark.reference.wavenet, benchmark.core.wavenet_weights\n"
         "import benchmark.counts.wavenet, benchmark.core.graph_kernels\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = json.loads(p.stdout.replace("'", '"'))
    assert "fpsc_tpu_torch" not in tops and "fpsc_tpu" not in tops
    assert "jax" not in tops


def test_the_references_blocks_are_the_whole_sequences():
    """dists in blocks of 64 samples (each on the receptive field before
    it) equals one pass over the whole signal."""
    from benchmark.core import wavenet_weights
    from benchmark.reference import wavenet as ref_wn
    cfg = tiny_wavenet()
    _, wv = wavenet_weights.weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 480), generator=g)
    feat = torch.randn((2, 3, 20), generator=g) * 0.3
    periods = torch.randint(32, 256, (2, 3), generator=g)
    whole = ref_wn.dists(wv, cfg["wavenet"], x, feat, periods, block=480)
    blocks = ref_wn.dists(wv, cfg["wavenet"], x, feat, periods, block=64)
    assert ref_wn.receptive_field(cfg["wavenet"]) == 2 * 7 + 8
    assert ref_wn.receptive_field(
        load("configs/wavenet_lpc.json")["wavenet"]) == 2078
    torch.testing.assert_close(blocks, whole, rtol=1e-5, atol=1e-6)


def test_the_weights_follow_the_seed_and_name_every_parameter():
    from benchmark.core import wavenet_weights
    from fpsc_tpu_torch.models import wavenet as wn
    cfg = tiny_wavenet()
    w1, v1 = wavenet_weights.weights(cfg, 2 ** 31 + 5, "cpu")
    w2, v2 = wavenet_weights.weights(cfg, 2 ** 31 + 5, "cpu")
    _, v3 = wavenet_weights.weights(cfg, 7, "cpu")
    assert all(torch.equal(v1[k], v2[k]) for k in v1)
    assert not torch.equal(v1["blocks.0.filter_conv.v"],
                           v3["blocks.0.filter_conv.v"])
    c = cfg["wavenet"]
    model = wn.Wavenet(wn.WavenetConfig(**{
        k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()
        if k not in ("periods",)}))
    assert set(model.state_dict()) == set(v1)
    for k, v in model.state_dict().items():
        assert tuple(v1[k].shape) == tuple(v.shape), k
    assert {"rnn1.wi", "rnn2.wh", "fc.w"} <= set(w1)


def _events():
    """A traced call: one generate annotation holding two graph launches
    (5 and 3 kernels) and a kernel launched alone; a launch outside."""
    def ev(cat, name, ts, dur, corr=None):
        e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    out = [ev("user_annotation", "fpsc.wavenet.generate", 100, 400),
           ev("cuda_runtime", "cudaGraphLaunch", 150, 5, 1),
           ev("cuda_runtime", "cudaLaunchKernel", 160, 5, 2),
           ev("cuda_runtime", "cudaGraphLaunch", 300, 5, 3),
           ev("cuda_runtime", "cudaGraphLaunch", 700, 5, 4)]
    out += [ev("kernel", "k", 200 + i, 2, 1) for i in range(5)]
    out += [ev("kernel", "alone", 210, 4, 2)]
    out += [ev("kernel", "k", 400 + i, 3, 3) for i in range(3)]
    out += [ev("kernel", "k", 800, 7, 4)]
    return out


def test_graph_kernels_counts_the_replays_inside_the_span():
    got = graph_kernels.launched(_events(), "fpsc.wavenet.generate")
    assert got == {"graph_launches": 2, "kernels": 8,
                   "kernel_s": pytest.approx((5 * 2 + 3 * 3) * 1e-6)}


class P:
    def __init__(self, name, t0, t1, **attrs):
        self.name, self.attrs = name, attrs
        self.t0, self.t1 = round(t0 * NS), round(t1 * NS)


def _record(launches=2, graph=True):
    rec = Record({"name": "t", "chips": 1}, load("configs/wavenet_lpc.json"),
                 {}, True)
    rec.spans = [Span("decode_file", 10.0, 11.0, {"traced": False}),
                 Span("decode_file", 11.0, 12.0, {"traced": True}),
                 Span("decode_file", 12.0, 13.0, {"traced": False})]
    rec.lists["wavenet_replays"] = [{"graph_launches": launches,
                                     "kernels": 221 * 256,
                                     "kernel_s": 0.1}]
    program = [P("wavenet.generate", 10.2, 10.8, batch=64, samples=16000,
                 chunk=128, replays=125, padded=0, graph=graph),
               P("wavenet.generate", 11.2, 11.8, batch=64, samples=250,
                 chunk=128, replays=2, padded=6, graph=graph)]
    return rec, (program, 0)


def test_the_wavenet_readers_on_a_record():
    rec, program = _record()
    step = reader("layer_metrics", "wavenet_step_us")(rec, program)
    assert step == pytest.approx(0.1 / 250 * 1e6)
    assert reader("layer_metrics", "wavenet_launches_per_step")(
        rec, program) == pytest.approx(221.0)
    least = counts.least_step_s(rec.config, 64) * 250
    roofline = reader("layer_metrics", "wavenet_roofline_pct")
    assert roofline(rec, program) == pytest.approx(100.0 * least / 0.1)
    # a bucket of 16 run in the 64 rows of a wider bucket's graph: the
    # kernels' work is at 64 rows
    program[0][1].attrs.update(batch=16, rows=64)
    assert roofline(rec, program) == pytest.approx(100.0 * least / 0.1)


@pytest.mark.parametrize("launches,graph", [(3, True), (2, False)])
def test_the_wavenet_readers_read_nothing_where_the_trace_disagrees(
        launches, graph):
    rec, program = _record(launches, graph)
    for name in ("wavenet_step_us", "wavenet_launches_per_step",
                 "wavenet_roofline_pct"):
        assert reader("layer_metrics", name)(rec, program) is None
    rec.lists.clear()
    assert reader("layer_metrics", "wavenet_step_us")(rec, program) is None


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the control needs a CUDA card (TF32)")


@pytest.mark.cuda
def test_the_wavenet_control_fails(tmp_path):
    """The reference in TF32 in the program's place fails eps_err's
    limit, at the published widths."""
    _card()
    from benchmark.drivers import decode_wavenet
    limits = load("limits/wn_bulk_decode.json")
    traffic = tiny_traffic()
    traffic["lengths"]["frames"] = 20
    rec = drive(decode_wavenet, load("configs/wavenet_lpc.json"), traffic,
                limits, tmp=tmp_path, control=True, device="cuda")
    ctl = rec.lists["control"][0]
    assert _failed(rec) == []
    assert not Check("eps_err", ctl["eps_err"], limits["eps_err"]).ok
