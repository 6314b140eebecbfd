"""Parity of the PyTorch port's encode-path modules with the JAX package.

Inputs are made with numpy from a seed and given to both sides; JAX runs
on the CPU (tests/conftest.py), the port with device="cpu", at the TINY
widths of tests/test_file_codec.py (predictor 32/16; books of 16, 4, (32,
16) and (8,) entries).  Tolerances:

* decisions (scalar and VQ indices, indicators, the FEC requantisation,
  pitch codes) identical; the VQ distances bit for bit, since both sum
  the 17 squares in index order with one rounding a term;
* pre-emphasis exact (numpy against numpy; the torch form one rounding
  a sample, as XLA contracts JAX's expression into a fused multiply-add);
* the GRU scans and the masks atol 1e-6 (the same f32 arithmetic, tanh
  and sigmoid rounded by other libraries);
* the encoder's c_in, r and r_qtz atol 1e-5 (the closed loop);
* cepstra atol 1e-4 (rfft, log10 and the band product of other
  libraries); the frontend's LPC atol 1e-3 (f32 Levinson, ROADMAP Queue C
  settled 4);
* pitch lags identical but for knife-edge argmax flips, at most 1% of the
  frames, correlations within 1e-4 where the lags agree
  (tests/test_frontend.py:119-136 bounds JAX's own search so against its
  f64 oracle);
* read_wav atol 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.codec import cli as jcli
from fpsc_tpu.codec import codec as jcodec
from fpsc_tpu.codec import plc as jplc
from fpsc_tpu.codec import rate_control as jrate
from fpsc_tpu.dsp import emphasis as jemph
from fpsc_tpu.dsp import frontend as jfront
from fpsc_tpu.eval import stoi as jstoi
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import gru as jgru
from fpsc_tpu.quant import scalar as jscalar
from fpsc_tpu.quant import vq as jvq

from fpsc_tpu_torch.codec import cli as tcli
from fpsc_tpu_torch.codec import codec as tcodec
from fpsc_tpu_torch.codec import plc as tplc
from fpsc_tpu_torch.codec import rate_control as trate
from fpsc_tpu_torch.dsp import emphasis as temph
from fpsc_tpu_torch.dsp import frontend as tfront
from fpsc_tpu_torch.eval import stoi as tstoi
from fpsc_tpu_torch.models import frame_predictor as tfp
from fpsc_tpu_torch.models import gru as tgru
from fpsc_tpu_torch.quant import scalar as tscalar
from fpsc_tpu_torch.quant import vq as tvq
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads

from test_frontend import _mixed_fixture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


F32 = dict(rtol=0, atol=1e-6)
CLOSED_LOOP = dict(rtol=0, atol=1e-5)
B, L = 3, 24


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
    return torch.as_tensor(np.array(x))


def _predictor(seed=5):
    params = jfp.init_frame_predictor(
        jax.random.PRNGKey(seed),
        jfp.FramePredictorConfig(gru_units1=32, gru_units2=16))
    return params, weights.predictor_from_params(_np_tree(params))


def _codebooks(rng, with_bl=True):
    books = jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(16)).astype(np.float32) * 0.1),
        vq=(jnp.asarray(rng.randn(32, 17).astype(np.float32) * 0.1),
            jnp.asarray(rng.randn(16, 17).astype(np.float32) * 0.03)),
        scl_bl=jnp.asarray(np.sort(rng.randn(4)).astype(np.float32) * 0.02)
        if with_bl else None,
        vq_bl=(jnp.asarray(rng.randn(8, 17).astype(np.float32) * 0.02),)
        if with_bl else None)
    return books, weights.codebooks_from_tree(_np_tree(books))


def _feat(rng, b=B, length=L):
    """Normalised frames: cepstra at the scale of the residuals, a pitch
    track at speech scale."""
    ceps = rng.randn(b, length, 18) * 0.15
    pitch = np.stack([rng.uniform(-1.3, 3.7, (b, length)),
                      rng.uniform(-0.5, 0.5, (b, length))], -1) / 24.1
    return np.concatenate([ceps, pitch], -1).astype(np.float32)


def _same_indices(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------- quant

@pytest.mark.parametrize("case", ["random", "ties"])
def test_scl_quantize_matches_jax(case):
    """Identical indices, values and counts; a value midway between two
    centres, or on a repeated centre, goes to the lower index."""
    rng = np.random.RandomState(1)
    codes = np.sort(rng.randn(16)).astype(np.float32) * 0.1
    data = (rng.randn(500) * 0.12).astype(np.float32)
    if case == "ties":
        codes = np.array([-0.5, -0.25, 0.0, 0.0, 0.25, 0.5, 0.5, 1.0],
                         np.float32)
        data = np.array([-0.375, -0.125, 0.0, 0.125, 0.375, 0.5, 0.75, 2.0,
                         -2.0], np.float32)
    want = jscalar.scl_quantize(jnp.asarray(data), jnp.asarray(codes))
    got = tscalar.scl_quantize(_t(data), _t(codes))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "ties":
        assert got[1].tolist() == [0, 1, 2, 2, 4, 5, 5, 7, 0]


def _vq_case(case):
    rng = np.random.RandomState(2)
    books = [rng.randn(32, 17).astype(np.float32) * 0.1,
             rng.randn(16, 17).astype(np.float32) * 0.03,
             rng.randn(8, 17).astype(np.float32) * 0.01]
    x = (rng.randn(300, 17) * 0.12).astype(np.float32)
    if case == "ties":
        # repeated entries tie exactly at every stage; rows on an entry
        # of stage 0, and on the midpoint of two of them
        books[0][7] = books[0][3]
        books[0][20] = books[0][3]
        books[1][9] = books[1][2]
        books[2][5] = books[2][4]
        x[:40] = books[0][rng.randint(0, 32, 40)]
        x[40:60] = 0.5 * (books[0][1] + books[0][2])
        x[60:70] = 0.0
    return books, x


@pytest.mark.parametrize("case", ["random", "ties"])
def test_sq_dist_is_jaxs_bit_for_bit(case):
    """The fixed-order fused sum gives JAX's CPU distances exactly."""
    books, x = _vq_case(case)
    for cb in books:
        want = np.asarray(jax.jit(jax.vmap(
            lambda v, cb=cb: jvq._sq_dist(v, jnp.asarray(cb))))(x))
        np.testing.assert_array_equal(tvq._sq_dist(_t(x), _t(cb)).numpy(),
                                      want)


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_vq_quantize_matches_jax(case, stages):
    """mbest_search / vq_quantize: identical indices and counts, the
    reconstruction exact."""
    books, x = _vq_case(case)
    books = books[:stages]
    want = jvq.vq_quantize(jnp.asarray(x), [jnp.asarray(b) for b in books])
    got = tvq.vq_quantize(_t(x), [_t(b) for b in books])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "ties":
        # a repeated entry is never chosen over its first occurrence
        assert not np.isin(got[1][:, 0].numpy(), [7, 20]).any()


# ---------------------------------------------------------------- GRU

@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    params, model = _predictor()
    rng = np.random.RandomState(3)
    xs = (rng.randn(B, L, 20) * 0.5).astype(np.float32)
    h0 = (rng.randn(B, 18) * 0.3).astype(np.float32)
    ys, h = jgru.gru_scan(params.mask_fwd, jnp.asarray(xs), jnp.asarray(h0),
                          reverse=reverse)
    with torch.no_grad():
        got_ys, got_h = tgru.gru_scan(model.mask_fwd, _t(xs), _t(h0),
                                      reverse=reverse)
    np.testing.assert_allclose(got_ys.numpy(), np.asarray(ys), **F32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), **F32)


def test_bigru_scan_and_mask_forward_match_jax():
    params, model = _predictor()
    rng = np.random.RandomState(4)
    xs = _feat(rng)
    want = jgru.bigru_scan(params.mask_fwd, params.mask_bwd, jnp.asarray(xs))
    with torch.no_grad():
        got = tgru.bigru_scan(model.mask_fwd, model.mask_bwd, _t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for scale in (1.0, 1000.0):
        want = jfp.mask_forward(params, jnp.asarray(xs), scale)
        with torch.no_grad():
            got = tfp.mask_forward(model, _t(xs), scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **_mask_tol(scale))


def _mask_tol(scale):
    """sigmoid(tanh(.) * scale) moves by up to scale / 4 times tanh's
    f32 difference (1e-6 atol at scale 1, 1e-5 at 1000: sigmoid's slope
    is small wherever tanh is not near 0)."""
    return dict(rtol=0, atol=1e-6 if scale == 1.0 else 1e-5)


# ---------------------------------------------------------------- encoder

ENCODER_CASES = {
    "threshold": dict(),
    "threshold_no_bl": dict(with_bl=False),
    "mask": dict(mask=True),
    "send": dict(send=True),
    "send_per_utterance": dict(send="rows"),
    "not_quantised": dict(qtz=False),
    "pitch_lag": dict(pitch_lag=1),
}


def _check_encoder_out(got, want, qtz=True):
    for k in ("ind1", "ind2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if qtz:
        _same_indices(got["indices"], want["indices"])
    for k in ("c_in", "r", "r_qtz", "r_under"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **CLOSED_LOOP, err_msg=k)


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_encoder_matches_jax(case):
    """frame_predictor.encoder: identical index streams and indicators,
    c_in, r and r_qtz within the closed loop's tolerance; the thresholds
    are chosen so that both indicators take both values."""
    opt = ENCODER_CASES[case]
    params, model = _predictor()
    rng = np.random.RandomState(5)
    jbooks, tbooks = _codebooks(rng, opt.get("with_bl", True))
    feat = _feat(rng)
    kw = dict(l1=0.4, l2=3.5, qtz=opt.get("qtz", True),
              pitch_lag=opt.get("pitch_lag", 0))
    jkw, tkw = dict(kw), dict(kw)
    if opt.get("mask"):
        mask = rng.rand(B, L, 2).astype(np.float32)
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), _t(mask)
    if opt.get("send") == "rows":
        send = rng.rand(B, L) > 0.3
        jkw["send"], tkw["send"] = jnp.asarray(send), send
    elif opt.get("send"):
        send = np.arange(L) % 3 != 2
        jkw["send"], tkw["send"] = jnp.asarray(send), send
    want = jfp.encoder(params, jnp.asarray(feat), codebooks=jbooks, **jkw)
    with torch.no_grad():
        got = tfp.encoder(model, _t(feat), codebooks=tbooks, **tkw)
    _check_encoder_out(got, want, kw["qtz"])
    for k in ("ind1", "ind2"):
        assert 0 < got[k].float().mean() < 1, (k, got[k].float().mean())
    if "send" in jkw:
        sent = np.broadcast_to(np.asarray(jkw["send"]), (B, L))
        assert not got["ind1"].numpy()[~sent].any()
        assert (got["indices"]["scl_bl"].numpy()[~sent] == -1).all()


@pytest.mark.parametrize("qtz", [True, False])
def test_mask_enc_matches_jax(qtz):
    params, model = _predictor(6)
    rng = np.random.RandomState(6)
    jbooks, tbooks = _codebooks(rng)
    feat = _feat(rng)
    want = jfp.mask_enc(params, jnp.asarray(feat), scale=1000.0,
                        codebooks=jbooks, qtz=qtz)
    with torch.no_grad():
        got = tfp.mask_enc(model, _t(feat), scale=1000.0, codebooks=tbooks,
                           qtz=qtz)
    assert sorted(got) == sorted(want)
    if qtz:
        _same_indices(got["indices"], want["indices"])
    for k in ("c_in", "r_orig", "r", "r_bl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **CLOSED_LOOP, err_msg=k)
    for k in ("scl_mask", "vct_mask"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **_mask_tol(1000.0))
    hard = (got["scl_mask"] > 0.5).float().mean()
    assert 0 < hard < 1


@pytest.mark.parametrize("use_mask", [False, True])
def test_codec_encode_and_usage_counts_match_jax(use_mask):
    """codec.encode: every key, the counts exactly; decode(encode) gives
    the coded frames back bit for bit, as in JAX."""
    params, model = _predictor(7)
    rng = np.random.RandomState(7)
    jbooks, tbooks = _codebooks(rng)
    feat = _feat(rng)
    want = jcodec.encode(params, jbooks, jnp.asarray(feat), l1=0.4,
                         l2=3.5, use_mask=use_mask, scale=1000.0)
    got = tcodec.encode(model, tbooks, _t(feat), l1=0.4, l2=3.5,
                        use_mask=use_mask, scale=1000.0)
    assert sorted(got) == sorted(want)
    for k in ("ind1", "ind2"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _same_indices(got["indices"], want["indices"])
    for k in ("coded", "r_qtz", "r"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **CLOSED_LOOP, err_msg=k)
    assert len(got["counts"]) == len(want["counts"]) == 5
    for g, w in zip(got["counts"], want["counts"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert sum(int(c.sum()) for c in got["counts"][:2]) == B * L
    direct = tfp.usage_counts(tbooks, got["indices"])
    for g, w in zip(direct, want["counts"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tcodec.decode(model, tbooks, got["ind1"], got["ind2"],
                         got["indices"], got["coded"][..., 18:])
    assert torch.equal(back, got["coded"])


@pytest.mark.parametrize("rows", [None, 7])
def test_fec_requantize_matches_jax(monkeypatch, rows):
    """The lean books' indices under the primary's indicators, identical;
    a search in chunks of rows gives the same indices."""
    if rows:
        monkeypatch.setattr(tplc, "FEC_ROWS", rows)
    rng = np.random.RandomState(8)
    jbooks, tbooks = _codebooks(rng)
    r = (rng.randn(B, L, 18) * 0.12).astype(np.float32)
    ind1, ind2 = rng.rand(B, L) > 0.5, rng.rand(B, L) > 0.4
    jlean = jrate.preset_codebooks(jbooks, **jrate.PRESETS["lean"])
    tlean = trate.preset_codebooks(tbooks, **trate.PRESETS["lean"])
    want = jplc.fec_requantize(jlean, jnp.asarray(r), jnp.asarray(ind1),
                               jnp.asarray(ind2))
    got = tplc.fec_requantize(tlean, _t(r), _t(ind1), _t(ind2))
    _same_indices(got, want)
    assert got["vq"].shape == (B, L, 1) and got["vq_bl"].shape == (B, L, 1)


# ---------------------------------------------------------------- frontend

def test_preemphasis_matches_jax():
    rng = np.random.RandomState(9)
    x = (rng.randn(3, 4000) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(temph.preemphasis(x), jemph.preemphasis(x))
    want = np.stack([np.asarray(jax.jit(jfront.preemphasis_jnp)(row))
                     for row in x])
    got = temph.preemphasis_torch(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], x[:, 0])


def test_frames_to_cepstra_matches_jax():
    x = _mixed_fixture(3, 2)[:9000]
    frames = jfront.frame_signal(x)
    want = np.asarray(jfront.frames_to_cepstra(jnp.asarray(frames)))
    got = tfront.frames_to_cepstra(_t(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tfront.vorbis_window(),
                                  jfront.vorbis_window())


def _lags(pitch):
    return np.round(np.asarray(pitch)[:, 0] * 50 + 100)


def _check_pitch(got, want, what):
    """Identical lags but for knife-edge flips (at most 1%), and the
    correlations within 1e-4 where the lags agree."""
    same = _lags(got) == _lags(want)
    assert float(np.mean(same)) >= 0.99, (what, float(np.mean(same)))
    np.testing.assert_allclose(np.asarray(got)[same, 1],
                               np.asarray(want)[same, 1], rtol=0, atol=1e-4)
    return int((~same).sum())


@pytest.mark.parametrize("seed", [0, 7])
def test_estimate_pitch_matches_jax(seed):
    """Against estimate_pitch_jnp and against the f64 numpy oracle, as
    tests/test_frontend.py bounds JAX's own search."""
    x = _mixed_fixture(seed)
    n = len(x) // 160 - 1
    got = tfront.estimate_pitch_torch(_t(x), n).numpy()
    flips = _check_pitch(got, jfront.estimate_pitch_jnp(jnp.asarray(x), n),
                         "jnp")
    _check_pitch(got, jfront.estimate_pitch(x, n), "numpy")
    print(f"pitch lags: {flips} knife-edge flips of {n} frames against "
          "estimate_pitch_jnp")
    assert tfront.estimate_pitch_torch(_t(x), 0).shape == (0, 2)


def _check_features(got, want):
    assert got.shape == want.shape
    if not len(got):
        return
    np.testing.assert_allclose(got[:, :18], want[:, :18], rtol=0, atol=1e-4)
    _check_pitch(got[:, 18:20], want[:, 18:20], "features")
    same = _lags(got[:, 18:20]) == _lags(want[:, 18:20])
    np.testing.assert_allclose(got[same, 20:], want[same, 20:], rtol=0,
                               atol=1e-3)


def test_extract_features_batch_matches_jax(monkeypatch):
    """Mixed lengths over two PITCH_SLAB buckets (and one too short to
    code), chunked at one slab so that a bucket takes two chunks; the
    single-utterance path gives the batch's rows."""
    monkeypatch.setattr(tfront, "PITCH_CHUNK_SLABS", 1)
    waves = [_mixed_fixture(0, 2), _mixed_fixture(1, 3),
             _mixed_fixture(2, 2)[:12345], np.zeros(100, np.float32),
             _mixed_fixture(4, 2)[:5000]]
    want = jfront.extract_features_batch(waves)
    got = tfront.extract_features_batch(waves, device="cpu")
    assert [g.shape for g in got] == [w.shape for w in want]
    assert len({-(-len(g) // tfront.PITCH_SLAB) for g in got if len(g)}) == 2
    for g, w in zip(got, want):
        _check_features(g, w)
    one = tfront.extract_features(_t(waves[2])).numpy()
    np.testing.assert_allclose(one, got[2], rtol=0, atol=1e-6)


# ---------------------------------------------------------------- read_wav

def _wav(path, rate, x):
    from scipy.io import wavfile
    wavfile.write(path, rate, (x * 32000).astype(np.int16))
    return path


@pytest.mark.parametrize("rate,channels", [(16000, 1), (8000, 1),
                                           (44100, 1), (16000, 2)])
def test_read_wav_matches_jax(tmp_path, rate, channels):
    rng = np.random.RandomState(rate + channels)
    n = rate // 5
    x = np.clip(rng.randn(n, channels) * 0.2, -1, 1)
    path = _wav(str(tmp_path / "x.wav"), rate, x[:, 0] if channels == 1
                else x)
    want = jcli.read_wav(path)
    got = tcli.read_wav(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if rate != 16000:
        assert len(got) == -(-n * 16000 // rate)


def test_resampler_matches_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(441)
    np.testing.assert_array_equal(tstoi._kaiser_lowpass(160, 441),
                                  jstoi._kaiser_lowpass(160, 441))
    np.testing.assert_array_equal(tstoi.resample_poly(x, 2, 1),
                                  jstoi.resample_poly(x, 2, 1))
