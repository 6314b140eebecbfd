"""Parity of the port's streaming serving with the JAX package's.

fpsc_tpu_torch/codec/streaming.py holds the per-tick steps and the seven
classes of fpsc_tpu/codec/streaming.py; on the CPU each tick runs
eagerly (on the card, as a replayed CUDA graph: tests/test_torch_card.py).
The same numpy inputs go to each JAX class and its port twin, at the
small widths of tests/test_streaming_and_rc.py: predictor GRU 24/12
(its head scaled by 0.05, so that the coded cepstra stay near speech and
the LPC synthesis filter stable), books of 8 / 4 scalar and (16,) / (8,)
VQ entries (lean FEC books of 4 / 2 and (8,)), LPCNet GRU_A 16, GRU_B 8,
embedding and conditioning 8.  Weights cross with train/weights.py.
Speech is fpsc_tpu.data.synthetic's; the vocoder's inputs are JAX's
frontend features of it.  Tolerances:

* frontend: cepstra atol 1e-4 (raw scale), pitch lags identical but for
  knife-edge argmax flips (at most 1% of the frames), correlations
  within 1e-4 where the lags agree (as tests/test_torch_encode.py);
* encoder, transmitter, codec: indicators and indices identical, coded
  frames atol 1e-5 (the closed loop);
* decoder and concealment: coded frames atol 1e-6 (the same f32 steps,
  tanh and sigmoid from other libraries);
* audio, with JAX's uniforms injected (the port draws its own,
  ROADMAP Queue C settled 10): the trajectory contract of
  lpcnet_sampler.trajectory_flips: for the vocoder on the same features,
  prefix rtol 1e-4, atol 1e-5 before an item's first flip and at least
  B - 1 items flip-free (JAX sums the cdf with jnp.cumsum, whose f32
  order the port does not reproduce); for the receiver and the codec,
  which synthesise their own coded features (atol 1e-5 apart, amplified
  by the f32 LPC and its synthesis filter, ROADMAP Queue C settled 4
  and 5), prefix rtol 1e-3, atol 1e-4;
* a batch of N against N single streams: rtol 1e-4, atol 1e-5 (as
  JAX's own test); reset() then the same ticks: equal.
"""
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.codec import streaming as js
from fpsc_tpu.data.synthetic import speech_like_waveform
from fpsc_tpu.dsp.frontend import extract_features
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import lpcnet as jl

from fpsc_tpu_torch.codec import streaming as ts
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.ops.lpcnet_sampler import trajectory_flips
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads

B, TICKS = 3, 12
CLOSED_LOOP = dict(rtol=0, atol=1e-5)
F32 = dict(rtol=0, atol=1e-6)
BATCHED = dict(rtol=1e-4, atol=1e-5)
# the receiver's and the codec's audio: their coded features differ from
# JAX's by up to 1e-5, which the f32 LPC of each frame and its synthesis
# filter amplify (ROADMAP Queue C settled 4 and 5)
END_TO_END = dict(rtol=1e-3, atol=1e-4)
KEYS = ("scl", "scl_bl", "vq", "vq_bl")
# thresholds that send a share of the frames below each of them
THRESH = dict(l1=0.43, l2=0.57)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _books(rng, scale, sizes):
    scl, scl_bl, vq, vq_bl = sizes
    return jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(scl)).astype(np.float32) * scale),
        vq=tuple(jnp.asarray(rng.randn(e, 17).astype(np.float32) * scale)
                 for e in vq),
        scl_bl=jnp.asarray(np.sort(rng.randn(scl_bl)).astype(np.float32)
                           * scale * 0.2),
        vq_bl=tuple(jnp.asarray(rng.randn(e, 17).astype(np.float32)
                                * scale * 0.2) for e in vq_bl))


def _speech(seed, n):
    return np.asarray(speech_like_waveform(np.random.RandomState(seed), n)
                      )[:n].astype(np.float32)


@pytest.fixture(scope="module")
def s():
    params = jfp.init_frame_predictor(
        jax.random.PRNGKey(3),
        jfp.FramePredictorConfig(gru_units1=24, gru_units2=12))
    params = params._replace(fc=jax.tree_util.tree_map(
        lambda a: a * 0.05, params.fc))
    rng = np.random.RandomState(5)
    books = _books(rng, 0.1, (8, 4, (16,), (8,)))
    fec_books = _books(rng, 0.1, (4, 2, (8,), (4,)))
    vparams = jl.init_lpcnet(jax.random.PRNGKey(1), jl.LPCNetConfig(
        gru_a_units=16, gru_b_units=8, embed_dim=8, cond_units=8))
    pcm = np.stack([_speech(20 + i, (TICKS + 1) * C.FRAME_SIZE)
                    for i in range(B)])
    feats = np.stack([np.asarray(extract_features(jnp.asarray(
        _speech(40 + i, (TICKS + 12) * C.FRAME_SIZE))))[10:10 + TICKS, :20]
        / C.MAXI for i in range(B)], 1).astype(np.float32)   # (T, B, 20)
    jenc = js.StreamingEncoder(params, books, batch=B, **THRESH)
    symbols = [jax.tree_util.tree_map(np.asarray, jenc.encode_frame(f))
               for f in feats]
    return dict(
        params=params, books=books, fec_books=fec_books, vparams=vparams,
        port=weights.predictor_from_params(_np_tree(params)),
        port_books=weights.codebooks_from_tree(_np_tree(books)),
        port_fec=weights.codebooks_from_tree(_np_tree(fec_books)),
        port_voc=weights.lpcnet_from_params(_np_tree(vparams)),
        pcm=pcm, feats=feats, symbols=symbols)


def _jax_uniforms(seed, ticks, b):
    """The uniforms a JAX vocoder class draws, tick by tick."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (C.FRAME_SIZE, b, 1))))
    return out


def _block(pcm, k):
    return pcm[..., k * C.FRAME_SIZE:(k + 1) * C.FRAME_SIZE]


def _same_symbols(got, want):
    np.testing.assert_array_equal(got["ind1"], np.asarray(want["ind1"]))
    np.testing.assert_array_equal(got["ind2"], np.asarray(want["ind2"]))
    for k in KEYS:
        np.testing.assert_array_equal(got["indices"][k],
                                      np.asarray(want["indices"][k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["coded"], np.asarray(want["coded"]),
                               **CLOSED_LOOP)


def _audio(got, want, end_to_end=False):
    """(ticks, B, 160) -> the trajectory contract on (B, ticks * 160):
    the vocoder's on the same features; END_TO_END where each side
    synthesises its own coded features."""
    g = np.concatenate(got, 1)
    w = np.concatenate([np.asarray(x) for x in want], 1)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    kw = END_TO_END if end_to_end else dict(min_clean=B - 1)
    return trajectory_flips(g, w, **kw)


def _lags(feat):
    return np.round(np.asarray(feat)[..., 18] * C.MAXI * 50 + 100)


# ------------------------------------------------------------ one class each

def test_frontend_matches_jax():
    ticks = 50
    pcm = np.stack([_speech(60 + i, ticks * C.FRAME_SIZE) for i in range(B)])
    jf = js.StreamingFrontend(batch=B)
    tf = ts.StreamingFrontend(batch=B, device="cpu")
    want = np.stack([np.asarray(jf.process_block(_block(pcm, k)))
                     for k in range(ticks)])
    got = np.stack([tf.process_block(_block(pcm, k)) for k in range(ticks)])
    assert got.shape == (ticks, B, 20)
    np.testing.assert_allclose(got[..., :18] * C.MAXI,
                               want[..., :18] * C.MAXI, rtol=0, atol=1e-4)
    same = _lags(got) == _lags(want)
    assert float(np.mean(same)) >= 0.99, float(np.mean(same))
    np.testing.assert_allclose(got[same, 19] * C.MAXI,
                               want[same, 19] * C.MAXI, rtol=0, atol=1e-4)


def test_encoder_matches_jax(s):
    enc = ts.StreamingEncoder(s["port"], s["port_books"], batch=B,
                              device="cpu", **THRESH)
    for f, want in zip(s["feats"], s["symbols"]):
        _same_symbols(enc.encode_frame(f), want)
    for key in ("ind1", "ind2"):
        share = np.mean([w[key] for w in s["symbols"]])
        assert 0.1 < share < 0.9, (key, share)


def test_decoder_matches_jax(s):
    jdec = js.StreamingDecoder(s["params"], s["books"], batch=B)
    tdec = ts.StreamingDecoder(s["port"], s["port_books"], batch=B,
                               device="cpu")
    for f, sym in zip(s["feats"], s["symbols"]):
        args = (sym["ind1"], sym["ind2"], sym["indices"], f[:, 18:])
        got = tdec.decode_frame(*args)
        np.testing.assert_allclose(got, np.asarray(jdec.decode_frame(*args)),
                                   **F32)
        # the decoder reproduces the encoder's closed loop
        np.testing.assert_allclose(got, sym["coded"], **CLOSED_LOOP)


def test_vocoder_matches_jax(s):
    jv = js.StreamingVocoder(s["vparams"], seed=4, batch=B)
    tv = ts.StreamingVocoder(s["port_voc"], seed=4, batch=B, device="cpu")
    us = _jax_uniforms(4, TICKS, B)
    want = [jv.synthesize_frame(f) for f in s["feats"]]
    got = [tv.synthesize_frame(f, uniforms=u)
           for f, u in zip(s["feats"], us)]
    assert got[0].shape == (B, C.FRAME_SIZE)
    flips, err = _audio(got, want)
    print(f"vocoder: flips {flips}, max prefix error {err:.3g}")


def _lost(ticks, b, seed=2):
    lost = np.random.RandomState(seed).rand(ticks, b) < 0.3
    lost[0] = False
    return lost


@pytest.mark.parametrize("case", ["loss", "fec", "damp"])
def test_receiver_matches_jax(s, case):
    """Concealment under a seeded loss pattern; with FEC books, frames
    recovered from redundancy; with damp and no energy cap."""
    kw = {"loss": {}, "fec": {}, "damp": dict(damp=0.5, energy_cap=False,
                                              fade_after=1)}[case]
    fec = case == "fec"
    jr = js.StreamingReceiver(s["params"], s["books"], s["vparams"], seed=6,
                              batch=B, fec_codebooks=s["fec_books"]
                              if fec else None, **kw)
    tr = ts.StreamingReceiver(s["port"], s["port_books"], s["port_voc"],
                              seed=6, batch=B, fec_codebooks=s["port_fec"]
                              if fec else None, device="cpu", **kw)
    rng = np.random.RandomState(3)
    lost = _lost(TICKS, B)
    us = _jax_uniforms(6, TICKS, B)
    got_audio, want_audio = [], []
    for k, (f, sym) in enumerate(zip(s["feats"], s["symbols"])):
        args = [sym["ind1"], sym["ind2"], sym["indices"], f[:, 18:],
                lost[k]]
        extra = {}
        if fec:
            from_fec = ~lost[k] & (rng.rand(B) < 0.5)
            extra = dict(fec_indices={
                "scl": rng.randint(0, 4, B), "scl_bl": rng.randint(0, 2, B),
                "vq": rng.randint(0, 8, (B, 1)),
                "vq_bl": rng.randint(0, 4, (B, 1))}, from_fec=from_fec)
        want = jr.process_symbols(*args, **extra)
        got = tr.process_symbols(*args, uniforms=us[k], **extra)
        np.testing.assert_allclose(got["coded"], np.asarray(want["coded"]),
                                   **CLOSED_LOOP)
        got_audio.append(got["audio"])
        want_audio.append(want["audio"])
    _audio(got_audio, want_audio, end_to_end=True)


def test_conceal_step_with_freeze_matches_jax(s):
    """freeze=True (no class argument in JAX either): the pure steps."""
    jstep = jax.jit(js._conceal_decoder_step(s["params"], s["books"],
                                             freeze=True))
    tstep = ts._conceal_decoder_step(s["port"], s["port_books"], freeze=True)
    jstate = tuple(jnp.zeros(shape) for shape in
                   ((B, 24), (B, 12), (B, 18), (B, 2), (B,)))
    tstate = tuple(torch.zeros(shape) for shape in
                   ((B, 24), (B, 12), (B, 18), (B, 2), (B,)))
    lost = _lost(TICKS, B, seed=5)
    for k, (f, sym) in enumerate(zip(s["feats"], s["symbols"])):
        jstate, want = jstep(jstate, jnp.asarray(sym["ind1"]),
                             jnp.asarray(sym["ind2"]),
                             {n: jnp.asarray(v) for n, v in
                              sym["indices"].items()},
                             jnp.asarray(f[:, 18:]), jnp.asarray(lost[k]))
        with torch.no_grad():
            tstate, got = tstep(tstate, torch.as_tensor(sym["ind1"]),
                                torch.as_tensor(sym["ind2"]),
                                {n: torch.as_tensor(v).long() for n, v in
                                 sym["indices"].items()},
                                torch.as_tensor(f[:, 18:]),
                                torch.as_tensor(lost[k]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_transmitter_matches_jax(s):
    jt = js.StreamingTransmitter(s["params"], s["books"], batch=B, **THRESH)
    tt = ts.StreamingTransmitter(s["port"], s["port_books"], batch=B,
                                 device="cpu", **THRESH)
    for k in range(TICKS + 1):
        _same_symbols(tt.process_pcm(_block(s["pcm"], k)),
                      jt.process_pcm(_block(s["pcm"], k)))


@pytest.mark.parametrize("from_pcm", [False, True])
def test_codec_matches_jax(s, from_pcm):
    jc = js.StreamingCodec(s["params"], s["books"], s["vparams"], seed=8,
                           batch=B, from_pcm=from_pcm, **THRESH)
    tc = ts.StreamingCodec(s["port"], s["port_books"], s["port_voc"],
                           seed=8, batch=B, from_pcm=from_pcm, device="cpu",
                           **THRESH)
    us = _jax_uniforms(8, TICKS, B)
    got_audio, want_audio = [], []
    for k in range(TICKS):
        if from_pcm:
            want = jc.process_pcm(_block(s["pcm"], k))
            got = tc.process_pcm(_block(s["pcm"], k), uniforms=us[k])
        else:
            want = jc.process_frame(s["feats"][k])
            got = tc.process_frame(s["feats"][k], uniforms=us[k])
        _same_symbols(got, want)
        got_audio.append(got["audio"])
        want_audio.append(want["audio"])
    _audio(got_audio, want_audio, end_to_end=True)
    with pytest.raises(ValueError):
        (tc.process_frame if from_pcm else tc.process_pcm)(
            np.zeros((B, 160 if from_pcm else 20), np.float32))


# ------------------------------------------- batch against singles, reset

def _make(kind, s, batch):
    p, bk, v = s["port"], s["port_books"], s["port_voc"]
    return {
        "frontend": lambda: ts.StreamingFrontend(batch=batch, device="cpu"),
        "encoder": lambda: ts.StreamingEncoder(p, bk, batch=batch,
                                               device="cpu", **THRESH),
        "decoder": lambda: ts.StreamingDecoder(p, bk, batch=batch,
                                               device="cpu"),
        "vocoder": lambda: ts.StreamingVocoder(v, batch=batch, device="cpu"),
        "receiver": lambda: ts.StreamingReceiver(
            p, bk, v, batch=batch, fec_codebooks=s["port_fec"],
            device="cpu"),
        "transmitter": lambda: ts.StreamingTransmitter(
            p, bk, batch=batch, device="cpu", **THRESH),
        "codec": lambda: ts.StreamingCodec(p, bk, v, batch=batch,
                                           from_pcm=True, device="cpu",
                                           **THRESH),
    }[kind]()


def _tick(kind, obj, s, k, rows, u):
    """Tick k of `obj` on stream rows `rows` (an index or a slice of
    the batch) -> its outputs, a row a stream."""
    f, sym, lost = s["feats"][k][rows], s["symbols"][k], _lost(TICKS, B)[k]
    block = _block(s["pcm"], k)[rows]
    idx = {n: v[rows] for n, v in sym["indices"].items()}
    u = u[:, rows].reshape(C.FRAME_SIZE, -1, 1)
    out = {
        "frontend": lambda: obj.process_block(block),
        "encoder": lambda: obj.encode_frame(f),
        "decoder": lambda: obj.decode_frame(sym["ind1"][rows],
                                            sym["ind2"][rows], idx,
                                            f[..., 18:]),
        "vocoder": lambda: obj.synthesize_frame(f, uniforms=u),
        "receiver": lambda: obj.process_symbols(
            sym["ind1"][rows], sym["ind2"][rows], idx, f[..., 18:],
            lost=lost[rows], from_fec=~lost[rows], uniforms=u,
            fec_indices={n: idx[n] % e for n, e in zip(KEYS, (4, 2, 8, 4))}),
        "transmitter": lambda: obj.process_pcm(block),
        "codec": lambda: obj.process_pcm(block, uniforms=u),
    }[kind]()
    n = 1 if isinstance(rows, int) else B
    if isinstance(out, dict):
        indices = out.pop("indices", {})
        out = {**out, **indices}
        return np.concatenate([np.asarray(out[name], np.float32).reshape(
            n, -1) for name in sorted(out)], 1)
    return np.asarray(out).reshape(n, -1)


KINDS = ["frontend", "encoder", "decoder", "vocoder", "receiver",
         "transmitter", "codec"]


@pytest.mark.parametrize("kind", KINDS)
def test_batch_equals_independent_streams(s, kind):
    """batch=N carries N independent sessions: the batch's rows equal N
    single-stream instances fed one stream each (their (dim,) inputs
    give squeezed outputs)."""
    ticks = 4
    us = _jax_uniforms(9, ticks, B)
    batch = _make(kind, s, B)
    singles = [_make(kind, s, 1) for _ in range(B)]
    for k in range(ticks):
        got = _tick(kind, batch, s, k, slice(None), us[k])
        want = [_tick(kind, singles[i], s, k, i, us[k]) for i in range(B)]
        np.testing.assert_allclose(got, np.concatenate(want), **BATCHED)


@pytest.mark.parametrize("kind", KINDS)
def test_reset_reproduces_the_first_run(s, kind):
    ticks = 4
    us = _jax_uniforms(10, ticks, B)
    obj = _make(kind, s, B)
    first = [_tick(kind, obj, s, k, slice(None), us[k]) for k in range(ticks)]
    obj.reset()
    again = [_tick(kind, obj, s, k, slice(None), us[k]) for k in range(ticks)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_rows_refuse_a_wrong_shape():
    with pytest.raises(ValueError):
        ts._rows(np.zeros((2, 20)), 3, 20)
    np.testing.assert_array_equal(ts._rows(np.ones(20), 1, 20),
                                  np.ones((1, 20), np.float32))


@pytest.mark.parametrize("name", [
    "StreamingFrontend", "StreamingEncoder", "StreamingDecoder",
    "StreamingVocoder", "StreamingReceiver", "StreamingTransmitter",
    "StreamingCodec"])
def test_constructors_take_jaxs_parameters_and_a_device(name):
    """Each class's parameters are its JAX twin's, in order and with its
    defaults, and then `device`: whether a tick replays a graph is no
    constructor's choice (utils.device.eager)."""
    def params(cls):
        return [(p.name, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]

    assert params(getattr(ts, name)) == params(getattr(js, name)) + [
        ("device", None)]
