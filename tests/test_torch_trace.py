"""The port's spans (fpsc_tpu_torch/utils/logging.py) and where the
program opens them.

The recorder: ids and parents, attributes, the ring's bound and its
count of the spans pushed out, `record_spans(False)`; under a CPU
torch.profiler each span is one annotation "fpsc.<name>", nested as
recorded, and with no profiler none is made.  The program: a decode of
a two-bucket container on the CPU records its phases under one root and
one sampler launch a bucket, with the bucket's batch and frames, and
`timings=` keeps its keys and adds the phases' own seconds; the phases
synchronise the card only where the caller asked for timings; each
bucket's feature decode records one `predictor.decoder` with its batch,
frames and path (the eager loop, or the chunks with their replays and
padded frames), and on the card the first call of a batch records its
`predictor.capture` inside it; a WaveNet's generation records its
chunks and the kernel they launched ("" for the plain chunk); every
streaming class's tick records a root with its stage, launch and
unpack.  Judged by structure, with no timing threshold.  Nothing here
loads JAX.
"""
import json
import types

import numpy as np
import pytest
import torch

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import cli, container
from fpsc_tpu_torch.codec import streaming as st
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.utils import logging as log
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def fresh_ring():
    was = log.record_spans(True)
    log.clear_spans()
    yield
    log.record_spans(was)
    log.clear_spans()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_by_parent_id_and_keep_their_attributes():
    with log.span("call", utterances=3) as root:
        with log.span("call.a", batch=2) as a:
            a.attrs["frames"] = 7
        with log.span("call.b") as b:
            with log.span("call.b.inner") as inner:
                pass
    got = log.spans()
    assert [s.name for s in got] == ["call.a", "call.b.inner", "call.b",
                                     "call"]
    assert root.parent == 0
    assert a.parent == b.parent == root.id
    assert inner.parent == b.id
    assert len({s.id for s in got}) == 4 and all(s.id > 0 for s in got)
    assert root.attrs == {"utterances": 3}
    assert a.attrs == {"batch": 2, "frames": 7}
    assert root.t0 <= a.t0 <= a.t1 <= b.t0 <= inner.t0 <= inner.t1 \
        <= b.t1 <= root.t1
    assert root.seconds == (root.t1 - root.t0) * 1e-9
    with log.span("after") as after:
        pass
    assert after.parent == 0


def test_begin_and_end_take_the_callers_clock_readings():
    s = log.span("phase", bytes=10)
    s.begin(1000)
    s.end(4000)
    assert (s.t0, s.t1, s.seconds) == (1000, 4000, 3e-6)
    assert log.spans() == [s]


def test_the_ring_keeps_the_latest_and_counts_the_dropped():
    extra = 17
    for i in range(log.SPAN_RING + extra):
        with log.span("s", i=i):
            pass
    got = log.spans()
    assert len(got) == log.SPAN_RING
    assert log.dropped_spans() == extra
    assert got[0].attrs["i"] == extra
    assert got[-1].attrs["i"] == log.SPAN_RING + extra - 1
    log.clear_spans()
    assert log.spans() == [] and log.dropped_spans() == 0


def test_record_spans_off_records_nothing_but_still_times():
    assert log.record_spans(False) is True
    with log.span("off") as s:
        with log.span("off.inner") as inner:
            pass
    assert log.spans() == [] and log.dropped_spans() == 0
    assert s.id == inner.id == 0
    assert s.t1 >= s.t0 > 0
    assert log.record_spans(True) is False
    with log.span("on"):
        pass
    assert [s.name for s in log.spans()] == ["on"]


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("fpsc.")]


def test_under_the_profiler_each_span_is_one_nested_annotation(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with log.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with log.span("tick", batch=4):
            with log.span("tick.stage"):
                torch.ones(3).sum()
            with log.span("tick.launch"):
                torch.ones(3).sum()
            with log.span("tick.unpack"):
                pass
    notes = _annotations(prof, tmp_path)
    names = sorted(e["name"] for e in notes)
    assert names == ["fpsc.tick", "fpsc.tick.launch", "fpsc.tick.stage",
                     "fpsc.tick.unpack"]
    by = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in notes}
    root = by["fpsc.tick"]
    for child in ("fpsc.tick.stage", "fpsc.tick.launch", "fpsc.tick.unpack"):
        assert root[0] <= by[child][0] <= by[child][1] <= root[1]
    assert by["fpsc.tick.stage"][1] <= by["fpsc.tick.launch"][0]
    assert by["fpsc.tick.launch"][1] <= by["fpsc.tick.unpack"][0]
    assert [s.name for s in log.spans()] == [
        "before", "tick.stage", "tick.launch", "tick.unpack", "tick"]


def test_without_a_profiler_no_annotation_is_made(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    with log.span("decode"):
        with log.span("decode.unpack"):
            pass
    assert len(log.spans()) == 2


@pytest.mark.parametrize("timed", [False, True])
def test_phases_synchronise_the_card_only_for_timings(monkeypatch, timed):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    card = types.SimpleNamespace(type="cuda")
    timings = {} if timed else None
    with cli._Phases("decode", timings, card) as phases:
        phases.begin("unpack", utterances=2)
        phases.begin("feature_decode", batch=2, frames=5)
        phases.begin("write")
        phases.end()
    assert len(syncs) == (3 if timed else 0)
    got = _by_name(log.spans())
    assert list(got) == ["decode.unpack", "decode.feature_decode",
                         "decode.write", "decode"]
    if timed:
        assert list(timings) == ["unpack", "feature_decode", "write"]
        for k, v in timings.items():
            assert v == got[f"decode.{k}"][0].seconds


# A two-bucket container at tiny widths, written and decoded by the port
# on the CPU with seeded random weights.
TINY = ["predictor.gru_units1=32", "predictor.gru_units2=16",
        "lpcnet.gru_a_units=32", "lpcnet.gru_b_units=8",
        "lpcnet.embed_dim=16", "lpcnet.cond_units=16",
        "codec.entropy_coding=false"]
SIZES = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}
LENGTHS = {"a": 3, "b": 4, "c": 3}


def _books():
    r = np.random.RandomState(5)

    def t(x):
        return torch.as_tensor(x.astype(np.float32))

    return fp.Codebooks(
        scl=t(np.sort(r.randn(SIZES["scl"])) * 0.1),
        vq=tuple(t(r.randn(e, 17) * 0.05) for e in SIZES["vq"]),
        scl_bl=t(np.sort(r.randn(SIZES["scl_bl"])) * 0.02),
        vq_bl=tuple(t(r.randn(e, 17) * 0.02) for e in SIZES["vq_bl"]))


def _payload(rng, frames):
    ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.5
    idx = {"scl": rng.randint(0, SIZES["scl"], frames),
           "scl_bl": rng.randint(0, SIZES["scl_bl"], frames),
           "vq": np.stack([rng.randint(0, e, frames) for e in SIZES["vq"]],
                          1),
           "vq_bl": np.stack([rng.randint(0, e, frames)
                              for e in SIZES["vq_bl"]], 1)}
    pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                      rng.uniform(-0.5, 0.5, frames)], 1)
    return bs.pack_utterance(ind1, ind2, idx, pitch, SIZES)


@pytest.fixture(scope="module")
def two_buckets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    cb_path = str(tmp / "cb.npz")
    ckpt.save_codebooks(cb_path, _books())
    rng = np.random.RandomState(4)
    utts = [(n, _payload(rng, f)) for n, f in LENGTHS.items()]
    path = str(tmp / "two.fpsc")
    container.write_fpsc(path, utts, SIZES)
    cfg = apply_overrides(Config(), TINY + [f"codec.codebook_path={cb_path}"])
    *artifacts, vocoder = cli.load_artifacts(cfg, need_vocoder=True,
                                             device="cpu")
    with torch.no_grad():                    # coded cepstra at speech scale
        artifacts[0].fc.w.mul_(0.05)
        artifacts[0].fc.b.mul_(0.05)
    return cfg, path, str(tmp / "wav"), artifacts, vocoder


def _decode(two_buckets, timings=None):
    cfg, path, out, artifacts, vocoder = two_buckets
    log.clear_spans()
    results = cli.decode_file(cfg, path, out, artifacts=artifacts,
                              vocoder=vocoder, device="cpu",
                              timings=timings)
    return results, log.spans()


def test_decode_file_records_its_phases_under_one_root(two_buckets):
    results, got = _decode(two_buckets)
    assert [r["name"] for r in results] == list(LENGTHS)
    by = _by_name(got)
    (root,) = by["decode"]
    assert root.parent == 0
    assert root.attrs == {"utterances": 3, "buckets": 2}
    phases = [s for s in got if s.parent == root.id]
    assert [s.name for s in phases] == ["decode.unpack"] + [
        "decode.feature_decode", "decode.ceps2lpc", "decode.prologue",
        "decode.sampler"] * 2 + ["decode.write"]
    for before, after in zip(phases, phases[1:]):
        assert before.t1 == after.t0
    assert root.t0 <= phases[0].t0 and phases[-1].t1 <= root.t1
    (unpack,) = by["decode.unpack"]
    assert unpack.attrs["utterances"] == 3 and unpack.attrs["bytes"] > 0
    assert [(s.attrs["batch"], s.attrs["frames"])
            for s in by["decode.feature_decode"]] == [(2, 3), (1, 4)]


def test_decode_file_records_one_sampler_launch_a_bucket(two_buckets):
    _, got = _decode(two_buckets)
    by = _by_name(got)
    launches = by["sampler.launch"]
    assert [(s.attrs["batch"], s.attrs["frames"]) for s in launches] == [
        (2, 3), (1, 4)]
    for s, phase in zip(launches, by["decode.sampler"]):
        assert s.parent == phase.id
        assert s.attrs["kernel"] == "sample_plain"
        assert s.attrs["bunch"] == 1
        assert s.attrs["steps"] == s.attrs["frames"] * 160
    assert "sampler.fold" not in by          # the CPU runs no fold


def test_decode_timings_keep_their_keys_and_read_the_spans(two_buckets):
    timings = {}
    _, got = _decode(two_buckets, timings)
    assert list(timings) == ["unpack", "feature_decode", "ceps2lpc",
                             "prologue", "sampler", "write"]
    by = _by_name(got)
    for k, v in timings.items():
        assert v == pytest.approx(sum(s.seconds for s in by[f"decode.{k}"]),
                                  rel=1e-12)


def test_decode_file_records_one_decoder_span_a_bucket(two_buckets):
    _, got = _decode(two_buckets)
    by = _by_name(got)
    decoders = by["predictor.decoder"]
    assert len(decoders) == 2
    for s, phase in zip(decoders, by["decode.feature_decode"]):
        assert s.parent == phase.id
        assert s.attrs == {"batch": phase.attrs["batch"],
                           "frames": phase.attrs["frames"], "graph": False,
                           "chunk": 0, "replays": 0, "padded": 0}
    assert "predictor.capture" not in by        # the CPU captures nothing


def test_decoder_span_counts_the_chunks_and_their_padding(two_buckets,
                                                          monkeypatch):
    """The chunked path on the CPU (its chunks run eagerly there): one
    replay a whole chunk, the last filled with zero frames."""
    monkeypatch.setattr(fp, "replays", lambda device: True)
    _, got = _decode(two_buckets)
    k = fp.DECODE_CHUNK
    assert [s.attrs for s in _by_name(got)["predictor.decoder"]] == [
        {"batch": 2, "frames": 3, "graph": False, "chunk": k,
         "replays": 1, "padded": k - 3},
        {"batch": 1, "frames": 4, "graph": False, "chunk": k,
         "replays": 1, "padded": k - 4}]


@pytest.mark.cuda
def test_on_the_card_a_batch_records_one_capture_then_replays():
    """Two decoder calls of one batch on the card: the first records the
    capture inside its own span, the second none; both replay the
    graph, a chunk at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decoder's graph is captured "
                    "on the card only")
    dev = torch.device("cuda")
    model = fp.FramePredictor(fp.FramePredictorConfig(gru_units1=24,
                                                      gru_units2=12),
                              torch.Generator().manual_seed(3)).to(dev)
    k = fp.DECODE_CHUNK
    rng = np.random.RandomState(2)
    log.clear_spans()
    with torch.no_grad():
        for frames in (200, 1237):
            fp.decoder(model, torch.as_tensor(
                rng.randn(2, frames, 2).astype(np.float32), device=dev),
                torch.as_tensor(rng.randn(2, frames, 18).astype(np.float32)
                                * 0.05, device=dev))
    by = _by_name(log.spans())
    (capture,) = by["predictor.capture"]
    first, second = by["predictor.decoder"]
    assert capture.attrs == {"batch": 2, "chunk": k}
    assert capture.parent == first.id
    assert first.t0 <= capture.t0 <= capture.t1 <= first.t1
    for s, frames in ((first, 200), (second, 1237)):
        n = -(-frames // k)
        assert s.attrs == {"batch": 2, "frames": frames, "graph": True,
                           "chunk": k, "replays": n,
                           "padded": n * k - frames}


def test_wavenet_generate_records_its_chunks_and_their_kernel():
    """A WaveNet's generation on the CPU: one `wavenet.generate` with its
    batch, samples, rows, chunks, padding, no graph, and no kernel (the
    plain chunk); no capture."""
    from fpsc_tpu_torch.models import wavenet as wn
    model = wn.Wavenet(wn.WavenetConfig(
        num_blocks=1, num_layers=2, residual_channels=16, gate_channels=24,
        skip_channels=16, cout_channels=24, front_kernel=8),
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.final2.g.mul_(0.05)
    g = torch.Generator().manual_seed(2)
    t = 200
    wn.generate(model, torch.randn((t, 2, 24), generator=g),
                torch.zeros((t, 2, 16)), torch.randn((t, 2), generator=g))
    by = _by_name(log.spans())
    (gen,) = by["wavenet.generate"]
    k = wn.WAVENET_CHUNK
    assert gen.attrs == {"batch": 2, "samples": t, "graph": False,
                         "rows": 2, "chunk": k, "replays": 2,
                         "padded": 2 * k - t, "kernel": ""}
    assert "wavenet.capture" not in by


# Every streaming class's tick at the small widths of
# tests/test_torch_streaming.py, on the CPU.
B = 2


@pytest.fixture(scope="module")
def stream_parts():
    g = torch.Generator().manual_seed(3)
    pred = fp.FramePredictor(fp.FramePredictorConfig(gru_units1=24,
                                                     gru_units2=12), g)
    with torch.no_grad():
        pred.fc.w.mul_(0.05)
        pred.fc.b.mul_(0.05)
    voc = LPCNet(LPCNetConfig(gru_a_units=16, gru_b_units=8, embed_dim=8,
                              cond_units=8), g)
    rng = np.random.RandomState(5)

    def t(x):
        return torch.as_tensor(x.astype(np.float32))

    books = fp.Codebooks(scl=t(np.sort(rng.randn(8)) * 0.05),
                         vq=(t(rng.randn(16, 17) * 0.03),),
                         scl_bl=t(np.sort(rng.randn(4)) * 0.02),
                         vq_bl=(t(rng.randn(8, 17) * 0.02),))
    pcm = (rng.randn(B, 160) * 1000).astype(np.float32)
    front = st.StreamingFrontend(batch=B, device="cpu")
    front.process_block(pcm)
    feat = front.process_block(pcm)
    sym = st.StreamingEncoder(pred, books, batch=B,
                              device="cpu").encode_frame(feat)
    return pred, books, voc, pcm, feat, sym


KINDS = ["frontend", "encoder", "decoder", "vocoder", "receiver",
         "transmitter", "codec", "codec_pcm"]
CLASSES = {"frontend": "StreamingFrontend", "encoder": "StreamingEncoder",
           "decoder": "StreamingDecoder", "vocoder": "StreamingVocoder",
           "receiver": "StreamingReceiver",
           "transmitter": "StreamingTransmitter", "codec": "StreamingCodec",
           "codec_pcm": "StreamingCodec"}


def _tick(kind, parts):
    """A new instance of the kind -> a function of one tick."""
    pred, books, voc, pcm, feat, sym = parts
    kw = dict(batch=B, device="cpu")
    obj = {
        "frontend": lambda: st.StreamingFrontend(**kw),
        "encoder": lambda: st.StreamingEncoder(pred, books, **kw),
        "decoder": lambda: st.StreamingDecoder(pred, books, **kw),
        "vocoder": lambda: st.StreamingVocoder(voc, seed=2, **kw),
        "receiver": lambda: st.StreamingReceiver(pred, books, voc, seed=2,
                                                 **kw),
        "transmitter": lambda: st.StreamingTransmitter(pred, books, **kw),
        "codec": lambda: st.StreamingCodec(pred, books, voc, seed=2, **kw),
        "codec_pcm": lambda: st.StreamingCodec(pred, books, voc, seed=2,
                                               from_pcm=True, **kw),
    }[kind]()
    symbols = (sym["ind1"], sym["ind2"], sym["indices"], feat[:, 18:20])
    return {
        "frontend": lambda: obj.process_block(pcm),
        "encoder": lambda: obj.encode_frame(feat),
        "decoder": lambda: obj.decode_frame(*symbols),
        "vocoder": lambda: obj.synthesize_frame(feat),
        "receiver": lambda: obj.process_symbols(*symbols),
        "transmitter": lambda: obj.process_pcm(pcm),
        "codec": lambda: obj.process_frame(feat),
        "codec_pcm": lambda: obj.process_pcm(pcm),
    }[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_a_streaming_tick_records_stage_launch_and_unpack(stream_parts,
                                                          kind):
    tick = _tick(kind, stream_parts)
    log.clear_spans()
    for _ in range(2):
        tick()
    got = log.spans()
    roots = [s for s in got if s.name == "tick"]
    assert len(roots) == 2
    for root in roots:
        assert root.parent == 0
        assert root.attrs == {"cls": CLASSES[kind], "batch": B,
                              "graph": False}
        kids = [s for s in got if s.parent == root.id]
        assert [s.name for s in kids] == ["tick.stage", "tick.launch",
                                          "tick.unpack"]
        assert root.t0 <= kids[0].t0
        for before, after in zip(kids, kids[1:]):
            assert before.t1 <= after.t0
        assert kids[-1].t1 <= root.t1
    assert len(got) == 8
