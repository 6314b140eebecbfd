"""The WaveNet-with-LPC vocoder on decode_file's path, on the CPU.

models/wavenet.py::GenerateChunks by chunk size against `generate_lpc`
(its chunks of WAVENET_CHUNK steps; tests/test_torch_wavenet.py holds
it to JAX's generator), bit for bit, for chunks that do not divide the
length, batch 1 and 3, and a call whose samples cross blocks of
projected conditioning (the block cut to 256 samples); a narrower batch
padded to the chunks' rows, and the one GenerateChunks the card keeps;
codec/cli.py::decode_file with `codec.vocoder=wavenet` at tiny widths
on seeded weights against the plain reference
benchmark/reference/wavenet.py (the draws its returned audio implies
under the reference, against the eps the program drew, within 1e-4 of
their spread; its wavs read back); the spans of a WaveNet bucket;
`load_vocoder`'s families and its checkpoint; and the LPCNet default,
which decodes bit for bit the sampler's output on the same operands.
The card's graph is tested in tests/test_torch_card.py.  Nothing here
loads JAX's WaveNet.
"""
import os
import wave

import numpy as np
import pytest
import torch

from benchmark.core import inputs, packer
from benchmark.reference import dsp
from benchmark.reference import wavenet as ref_wn
from fpsc_tpu_torch.codec import cli
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.ops import lpcnet_sampler
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.utils import logging as log
from fpsc_tpu_torch.utils.device import torch_threads

WIDTHS = dict(num_blocks=2, num_layers=3, residual_channels=16,
              gate_channels=24, skip_channels=16, cout_channels=24,
              front_kernel=8)
CODEC = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8],
         "code_dims": 17, "l1": 0.09, "l2": 0.28}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


def _wavenet(seed=0):
    """A small seeded WaveNet, final2's gains scaled by 0.05 (a random
    net's log_std drives its feedback past 1e6 otherwise)."""
    model = wn.Wavenet(wn.WavenetConfig(**WIDTHS),
                       torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.final2.g.mul_(0.05)
    return model.requires_grad_(False)


def _operands(batch, frames, seed=0):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((batch, 20, frames), generator=g) * 0.3
    periods = torch.randint(32, 256, (batch, frames), generator=g)
    lpc = torch.randn((batch, frames, 16), generator=g) * 0.04
    eps = torch.randn((frames * C.FRAME_SIZE, batch), generator=g)
    return feat, periods, wn.sample_lpc(lpc), eps


@pytest.mark.parametrize("batch,frames,chunk", [
    (1, 3, 32),           # 480 samples: 15 whole chunks
    (3, 2, 64),           # 320: 5 whole chunks
    (3, 1, 256),          # 160: one part chunk
])
def test_chunks_give_generate_lpcs_samples(batch, frames, chunk,
                                           monkeypatch):
    """generate_lpc's chunks of 128 steps (480 samples: 3 whole chunks
    and a part) against chunks of another size."""
    model = _wavenet()
    feat, periods, lpc_sample, eps = _operands(batch, frames, seed=frames)
    want = wn.generate_lpc(model, model.cfg, feat, periods, lpc_sample,
                           eps=eps)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    monkeypatch.setattr(wn, "WAVENET_CHUNK", chunk)
    chunks = wn.GenerateChunks(model, batch, "cpu")
    assert chunks.graph is None                 # the CPU runs eagerly
    got = chunks.run(model, cond, lpc, eps)
    assert torch.equal(got, want)
    # a second call starts from the zero state again
    assert torch.equal(chunks.run(model, cond, lpc, eps), want)


def test_chunks_cross_blocks_of_conditioning(monkeypatch):
    """Blocks of 256 samples: a 5-frame call projects 4 blocks, the
    last a part; chunks of 128, 64 and 256 steps give the samples of
    chunks of 32."""
    monkeypatch.setattr(wn, "COND_BLOCK", 256)
    model = _wavenet(1)
    feat, periods, lpc_sample, eps = _operands(2, 5, seed=7)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    monkeypatch.setattr(wn, "WAVENET_CHUNK", 32)
    want = wn.generate(model, cond, lpc, eps)
    for chunk in (128, 64, 256):
        monkeypatch.setattr(wn, "WAVENET_CHUNK", chunk)
        chunks = wn.GenerateChunks(model, 2, "cpu")
        assert torch.equal(chunks.run(model, cond, lpc, eps), want)
    assert torch.equal(wn.generate_lpc(model, model.cfg, feat, periods,
                                       lpc_sample, eps=eps), want)


def test_chunks_follow_an_edited_module():
    model = _wavenet(2)
    feat, periods, lpc_sample, eps = _operands(1, 1, seed=2)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    chunks = wn.GenerateChunks(model, 1, "cpu")
    before = chunks.run(model, cond, lpc, eps)
    with torch.no_grad():
        model.final2.b.add_(0.5)
    after = chunks.run(model, cond, lpc, eps)
    assert torch.equal(after, wn.generate_lpc(model, model.cfg, feat,
                                              periods, lpc_sample, eps=eps))
    assert not torch.equal(after, before)


def test_a_chunk_must_divide_the_conditioning_block(monkeypatch):
    monkeypatch.setattr(wn, "WAVENET_CHUNK", 96)
    with pytest.raises(ValueError, match="does not divide"):
        wn.GenerateChunks(_wavenet(), 1, "cpu")


def test_a_narrower_batch_runs_padded_in_the_chunks_rows():
    """Chunks of 4 rows given 2 of the batch: the first 2 rows of the
    whole batch's samples, bit for bit (the rows never mix, and the
    products keep their shapes); a wider batch is refused."""
    model = _wavenet(3)
    feat, periods, lpc_sample, eps = _operands(4, 2, seed=3)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    chunks = wn.GenerateChunks(model, 4, "cpu")
    whole = chunks.run(model, cond, lpc, eps)
    narrow = chunks.run(model, cond[:, :2], lpc[:, :2], eps[:, :2])
    assert narrow.shape == (2, 320)
    assert torch.equal(narrow, whole[:2])
    with pytest.raises(ValueError, match="wider"):
        wn.GenerateChunks(model, 1, "cpu").run(model, cond, lpc, eps)


def test_the_card_keeps_one_graph_at_the_widest_batch(monkeypatch):
    """Where generation replays (patched in here; the CPU captures
    nothing): one GenerateChunks a WaveNet, made at the first batch and
    kept for narrower ones, made anew for a wider batch or another
    de-emphasis; the span's rows are its rows.  Elsewhere none is
    kept."""
    model = _wavenet(4)
    feat, periods, lpc_sample, eps = _operands(3, 1, seed=4)
    cond, lpc = wn.step_inputs(model, model.cfg, feat, periods, lpc_sample)
    wn.generate(model, cond, lpc, eps)
    assert model not in wn._CHUNKS
    monkeypatch.setattr(wn, "replays", lambda device: True)
    log.clear_spans()
    kept = []
    for b, de in ((2, 0.85), (1, 0.85), (2, 0.85), (3, 0.85), (3, 0.0)):
        wn.generate(model, cond[:, :b], lpc[:, :b], eps[:, :b],
                    deemphasis=de)
        kept.append(wn._CHUNKS[model])
    assert [k.rows for k in kept] == [2, 2, 2, 3, 3]
    assert [len({id(k) for k in kept[:i]}) for i in (3, 4, 5)] == [1, 2, 3]
    assert [s.attrs["rows"] for s in log.spans()
            if s.name == "wavenet.generate"] == [2, 2, 2, 3, 3]


def _cfg(tmp_path, extra=()):
    """A tiny codec and a WaveNet of WIDTHS behind the default predictor,
    the books and priors from the benchmark's seeded inputs."""
    books = inputs.codebooks({"codec": CODEC}, 5)
    priors = inputs.priors({"codec": CODEC}, 5)
    cb = str(tmp_path / "books.npz")
    np.savez(cb, **books, **{f"prior__{k}": v for k, v in priors.items()})
    return apply_overrides(Config(), [
        "codec.vocoder=wavenet", *(f"wavenet.{k}={v}"
                                   for k, v in WIDTHS.items()),
        "codec.scl_entries=16", "codec.scl_entries_bl=4",
        "codec.vq_entries=32,16", "codec.vq_entries_bl=8",
        f"codec.codebook_path={cb}", *extra]), books, priors


def _container(path, books, priors, frames=(3, 3, 2), seed=4):
    """Utterances of random symbols, range-coded by the benchmark's own
    packer -> (path, utterances)."""
    sz = inputs.sizes({"codec": CODEC})
    g = inputs.rng(seed, 0)
    utts = [inputs.Utterance(g, sz, n) for n in frames]
    orders = packer.scalar_orders(books)
    packer.write_container(path, [(f"u{i}", packer.pack_utterance(
        u.ind1, u.ind2, u.idx, u.pcodes, sz, priors, orders))
        for i, u in enumerate(utts)], sz, CODEC["l1"], CODEC["l2"])
    return path, utts


def _seeded(artifacts, vocoder, seed=3):
    """Seeded weights in place: the predictor's head at speech size, the
    WaveNet's final2 gains scaled by 0.05."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        artifacts[0].fc.w.mul_(0.05)
        artifacts[0].fc.b.mul_(0.05)
        for p in vocoder.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.01)
        vocoder.final2.g.mul_(0.05)


def _eps_of(lengths):
    """decode_file's default eps: one torch.randn (samples, bucket) a
    bucket of equal lengths, container order, a generator seeded 0."""
    out = [None] * len(lengths)
    for f in dict.fromkeys(lengths):
        members = [i for i, n in enumerate(lengths) if n == f]
        gen = torch.Generator().manual_seed(0)
        e = torch.randn((f * C.FRAME_SIZE, len(members)), generator=gen)
        for j, i in enumerate(members):
            out[i] = e[:, j]
    return out


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wn_decode")
    cfg, books, priors = _cfg(tmp)
    path, utts = _container(str(tmp / "x.fpsc"), books, priors)
    *artifacts, vocoder = cli.load_artifacts(cfg, need_vocoder=True,
                                             device="cpu")
    _seeded(artifacts, vocoder)
    log.clear_spans()
    results = cli.decode_file(cfg, path, str(tmp / "wav"),
                              artifacts=artifacts, vocoder=vocoder,
                              device="cpu")
    return dict(cfg=cfg, path=path, utts=utts, artifacts=artifacts,
                vocoder=vocoder, results=results, out=tmp / "wav",
                spans=log.spans(), tmp=tmp)


def test_decode_file_draws_hold_to_the_reference(decoded):
    """Every sample's draw, as the plain reference reads it from the
    returned audio (teacher-forced on the program's own signal, LPC and
    coded frames), is the eps the program drew, within 1e-4 of its
    spread."""
    wv = {k: v for k, v in decoded["vocoder"].state_dict().items()}
    wcfg = dict(WIDTHS, kernel_size=2, inp_channels=1, out_channels=2,
                upsample_scales=[10, 16])
    for r, e in zip(decoded["results"], _eps_of(
            [u.frames for u in decoded["utts"]])):
        frames = len(r["coded"])
        assert r["wav"].shape == (frames * C.FRAME_SIZE,)
        coded = torch.as_tensor(r["coded"])[None]
        periods = (0.1 + 50.0 * (coded[..., 18] * dsp.MAXI) + 100.0).to(
            torch.int32)
        err = ref_wn.eps_errors(wv, wcfg, torch.as_tensor(r["wav"])[None],
                                torch.as_tensor(r["lpc"])[None], coded,
                                periods, e[None])
        assert float(err.max()) <= 1e-4, r["name"]
        # an altered sample is off by its change over the spread
        y = torch.as_tensor(r["wav"]).clone()
        y[100] += 0.05
        bad = ref_wn.eps_errors(wv, wcfg, y[None],
                                torch.as_tensor(r["lpc"])[None], coded,
                                periods, e[None])
        assert float(bad.max()) > 1e-2


def test_decode_file_writes_the_returned_audio(decoded):
    for r in decoded["results"]:
        with wave.open(str(decoded["out"] / f"{r['name']}.wav"), "rb") as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
        np.testing.assert_array_equal(pcm, dsp.wav_int16(r["wav"]))


def test_decode_file_generation_is_generate_lpcs(decoded):
    """The bucket of two 3-frame utterances voiced by generate_lpc on the
    returned coded frames and LPC, with the same eps: bit for bit."""
    rs = decoded["results"][:2]
    coded = torch.as_tensor(np.stack([r["coded"] for r in rs]))
    lpc = torch.as_tensor(np.stack([r["lpc"] for r in rs]))
    periods = (0.1 + 50.0 * (coded[..., 18] * C.MAXI) + 100.0).to(
        torch.int32)
    eps = torch.stack(_eps_of([3, 3]), 1)
    want = wn.generate_lpc(decoded["vocoder"], decoded["vocoder"].cfg,
                           coded.transpose(1, 2), periods,
                           wn.sample_lpc(lpc), eps=eps)
    got = np.stack([r["wav"] for r in rs])
    np.testing.assert_array_equal(got, want.numpy())


def test_a_wavenet_bucket_is_a_wavenet_phase(decoded):
    """decode.wavenet in place of decode.sampler, wavenet.generate under
    it with the chunks' attributes; no capture on the CPU."""
    spans = decoded["spans"]
    names = [s.name for s in spans]
    assert "decode.sampler" not in names and "wavenet.capture" not in names
    phases = [s for s in spans if s.name == "decode.wavenet"]
    gens = [s for s in spans if s.name == "wavenet.generate"]
    assert len(phases) == len(gens) == 2
    for p, g in zip(phases, gens):
        assert g.parent == p.id
    assert [(g.attrs["batch"], g.attrs["samples"], g.attrs["rows"],
             g.attrs["chunk"], g.attrs["replays"], g.attrs["padded"],
             g.attrs["graph"]) for g in gens] == [
        (2, 480, 2, 128, 4, 32, False), (1, 320, 1, 128, 3, 64, False)]


def test_load_vocoder_builds_each_family(tmp_path):
    cfg = apply_overrides(Config(), ["codec.vocoder=wavenet",
                                     "wavenet.residual_channels=8",
                                     f"train.save_dir={tmp_path}"])
    voc = cli.load_vocoder(cfg, "cpu")
    assert isinstance(voc, wn.Wavenet)
    assert voc.cfg.residual_channels == 8 and voc.cfg.gate_channels == 256
    with torch.no_grad():
        voc.front.b.fill_(0.25)
    ckpt.save(ckpt.checkpoint_path(str(tmp_path), "wn_s", 0), voc)
    cfg.train.vocoder_model, cfg.train.vocoder_epoch = "wn_s", 0
    back = cli.load_vocoder(cfg, "cpu")
    assert torch.equal(back.front.b, torch.full((8,), 0.25))
    with pytest.raises(ValueError, match="lpcnet, wavenet"):
        cli.load_vocoder(apply_overrides(Config(), ["codec.vocoder=iaf"]),
                         "cpu")
    with pytest.raises(ValueError, match="codec.vocoder=wavenet"):
        cli.load_vocoder(apply_overrides(Config(), ["lpcnet.bunch=3"]), "cpu")


def test_the_lpcnet_default_decodes_as_the_sampler_does(tmp_path):
    """The default family: each bucket's samples are the sampler's on
    the decoder's coded frames, LPC and the uniforms of a generator
    seeded 0, bit for bit."""
    cfg, books, priors = _cfg(tmp_path)
    cfg.codec.vocoder = "lpcnet"
    path, _ = _container(str(tmp_path / "x.fpsc"), books, priors,
                         frames=(2, 2))
    *artifacts, vocoder = cli.load_artifacts(cfg, need_vocoder=True,
                                             device="cpu")
    results = cli.decode_file(cfg, path, str(tmp_path / "wav"),
                              artifacts=artifacts, vocoder=vocoder,
                              device="cpu")
    coded = torch.as_tensor(np.stack([r["coded"] for r in results]))
    un = coded * C.MAXI
    periods = (0.1 + 50.0 * un[..., 18] + 100.0).to(torch.int32)
    _, lpc, _ = ceps2lpc(un.reshape(-1, 20)[:, :18])
    u = torch.rand((2, 2, C.FRAME_SIZE),
                   generator=torch.Generator().manual_seed(0))
    ops, meta = lpcnet_sampler.prepare(
        vocoder, coded, periods, lpc.reshape(2, 2, 16), u, corr=un[..., 19],
        dtype=torch.float32,
        gru_a_pattern=lpcnet_sampler.auto_block_pattern(vocoder))
    want = lpcnet_sampler.sample(ops, meta).numpy()
    np.testing.assert_array_equal(np.stack([r["wav"] for r in results]),
                                  want)
    np.testing.assert_array_equal(
        np.stack([r["lpc"] for r in results]), lpc.reshape(2, 2, 16).numpy())
    assert os.path.exists(tmp_path / "wav" / "u0.wav")
