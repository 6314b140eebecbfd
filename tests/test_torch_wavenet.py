"""The port's WaveNet family and predictor variants against JAX's.

fpsc_tpu_torch/dsp/gaussian.py, dsp/stft.py, models/wavenet.py,
models/wavenet_iaf.py, models/frame_predictor_para.py and
models/attention.py against their fpsc_tpu twins at the small widths of
tests/test_wavenet.py, the JAX parameters carried across by
train/weights.py's `*_from_params`, the inputs numpy from a seed.
Tolerances: rtol 1e-5 (atol 1e-6 where values cross zero) for the
losses, spectra, convolutions, the teacher-forced stack, the flows, the
predictor variant and the attention; `generate_lpc` with JAX's eps
injected at rtol 1e-4, atol 1e-5 over 320 samples (its feedback
carries each step's rounding on); the indicators and index streams
equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpsc_tpu.dsp import gaussian as jg
from fpsc_tpu.dsp import stft as jstft
from fpsc_tpu.models import attention as jatt
from fpsc_tpu.models import frame_predictor_para as jpara
from fpsc_tpu.models import wavenet as jwn
from fpsc_tpu.models import wavenet_iaf as jiaf
from fpsc_tpu.models.frame_predictor import Codebooks as JCodebooks

from fpsc_tpu_torch.dsp import gaussian as tg
from fpsc_tpu_torch.dsp import stft as tstft
from fpsc_tpu_torch.models import attention as tatt
from fpsc_tpu_torch.models import frame_predictor_para as tpara
from fpsc_tpu_torch.models import wavenet as twn
from fpsc_tpu_torch.models import wavenet_iaf as tiaf
from fpsc_tpu_torch.models.frame_predictor import Codebooks
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


JCFG = jwn.WavenetConfig(num_blocks=1, num_layers=3, residual_channels=16,
                         gate_channels=24, skip_channels=16,
                         cin_channels=20, cout_channels=24, front_kernel=8)
TCFG = twn.WavenetConfig(num_blocks=1, num_layers=3, residual_channels=16,
                         gate_channels=24, skip_channels=16,
                         cin_channels=20, cout_channels=24, front_kernel=8)
ICFG = dict(num_flows=2, num_layers=3, residual_channels=8, gate_channels=12,
            skip_channels=8, cout_channels=12, front_channels=8)


_JFORWARD = jax.jit(jwn.forward, static_argnums=1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def wavenet():
    params = jwn.init_wavenet(jax.random.PRNGKey(0), JCFG)
    return params, weights.wavenet_from_params(
        _np(params), TCFG).requires_grad_(False)


def _inputs(seed, b=2, frames=2):
    rng = np.random.RandomState(seed)
    t = frames * 160
    x = (rng.randn(b, 1, t) * 0.1).astype(np.float32)
    c = (rng.randn(b, 20, frames) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (b, frames)).astype(np.int32)
    return x, c, periods


# ---------------------------------------------------------------- dsp

def test_gaussian_nll_and_kl():
    rng = np.random.RandomState(1)
    y_hat = rng.randn(3, 50, 2).astype(np.float32)
    y_hat[0, :5, 1] = -12.0                       # below the log-std floor
    y = rng.randn(3, 50).astype(np.float32)
    _close(tg.gaussian_nll(_t(y_hat), _t(y)),
           jg.gaussian_nll(jnp.asarray(y_hat), jnp.asarray(y)))
    mu_q, logs_q, mu_p, logs_p = (rng.randn(4, 60).astype(np.float32)
                                  * s for s in (1.0, 2.0, 1.0, 2.0))
    logs_q[:4] = -8.0
    for reg in (True, False):
        got_kl, got_reg = tg.kl_gaussians(*map(_t, (mu_q, logs_q, mu_p,
                                                    logs_p)),
                                          regularization=reg)
        want_kl, want_reg = jg.kl_gaussians(*map(jnp.asarray, (
            mu_q, logs_q, mu_p, logs_p)), regularization=reg)
        _close(got_kl, want_kl)
        assert (got_reg is None) == (want_reg is None)
        if reg:
            _close(got_reg, want_reg)
        for g, w in zip(tg.kl_loss(*map(_t, (mu_q, logs_q, mu_p, logs_p)),
                                   regularization=reg),
                        jg.kl_loss(*map(jnp.asarray, (mu_q, logs_q, mu_p,
                                                      logs_p)),
                                   regularization=reg)):
            _close(torch.as_tensor(g), w)


def test_sample_from_gaussian_with_injected_eps():
    rng = np.random.RandomState(2)
    y_hat = rng.randn(2, 30, 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jg.sample_from_gaussian(key, jnp.asarray(y_hat))
    eps = np.asarray(jax.random.normal(key, (2, 30)))
    _close(tg.sample_from_gaussian(_t(y_hat), eps=_t(eps)), want)
    a = tg.sample_from_gaussian(_t(y_hat),
                                generator=torch.Generator().manual_seed(3))
    b = tg.sample_from_gaussian(_t(y_hat),
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("scale", ["linear", "log"])
def test_stft_mag(scale):
    rng = np.random.RandomState(3)
    y = (rng.randn(2, 2399) * 0.3).astype(np.float32)
    want = jstft.stft_mag(jnp.asarray(y), scale=scale)
    got = tstft.stft_mag(_t(y), scale=scale)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-5 if scale == "linear" else 1e-4)


def test_mel_spec_and_filterbank():
    rng = np.random.RandomState(4)
    y = (rng.randn(2, 3000) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(tstft.mel_filterbank(40),
                                  jstft.mel_filterbank(40))
    _close(tstft.mel_spec(_t(y), n_mels=40),
           jstft.mel_spec(jnp.asarray(y), n_mels=40), atol=1e-4)


# ---------------------------------------------------------------- wavenet

@pytest.mark.parametrize("dilation,causal", [(1, True), (4, True),
                                             (1, False), (2, False)])
def test_conv1d(dilation, causal):
    rng = np.random.RandomState(5)
    k = 3 if not causal else 2
    p = jwn.init_wnconv(jax.random.PRNGKey(dilation), 6, 5, k)
    p = p._replace(g=p.g * 1.3, b=jnp.asarray(rng.randn(5), jnp.float32))
    conv = twn.WNConv(6, 5, k, torch.Generator())
    weights.load_into(conv, _np(p))
    x = rng.randn(2, 6, 40).astype(np.float32)
    _close(twn.conv1d(conv, _t(x), dilation, causal),
           jwn.conv1d(p, jnp.asarray(x), dilation, causal))


def test_upsample_with_asymmetric_kernels(wavenet):
    """Each transposed kernel made asymmetric in both axes (so that a
    flip of either shows), with a gain and a bias off their defaults."""
    params, _ = wavenet
    up = params.upsampler
    convt = tuple(k + jnp.arange(k.size, dtype=jnp.float32).reshape(
        k.shape) * 0.05 for k in up.convt)
    up = up._replace(convt=convt,
                     convt_g=tuple(g * 1.7 for g in up.convt_g),
                     convt_b=tuple(jnp.asarray(0.03 * (i + 1), jnp.float32)
                                   for i in range(len(convt))))
    params = params._replace(upsampler=up)
    model = weights.wavenet_from_params(_np(params), TCFG)
    _, c, periods = _inputs(6, frames=3)
    periods[0, 0] = 700                           # clipped to 511
    got = twn.upsample(model.upsampler, TCFG, _t(c), _t(periods))
    assert tuple(got.shape) == (2, TCFG.cout_channels, 3 * 160)
    _close(got, jwn.upsample(up, JCFG, jnp.asarray(c),
                             jnp.asarray(periods)))


def test_forward_and_causality(wavenet):
    params, model = wavenet
    x, c, periods = _inputs(7, b=1)
    want = np.asarray(_JFORWARD(params, JCFG, jnp.asarray(x),
                                  jnp.asarray(periods), jnp.asarray(c)))
    got = twn.forward(model, TCFG, _t(x), _t(periods), _t(c))
    _close(got, want)
    x2 = x.copy()
    t0 = 200
    x2[0, 0, t0] += 1.0
    got2 = twn.forward(model, TCFG, _t(x2), _t(periods), _t(c)).numpy()
    np.testing.assert_allclose(got2[..., :t0], got.numpy()[..., :t0],
                               rtol=1e-5, atol=1e-6)
    assert np.abs(got2[..., t0:] - got.numpy()[..., t0:]).max() > 1e-4
    _close(torch.as_tensor(got2), _JFORWARD(
        params, JCFG, jnp.asarray(x2), jnp.asarray(periods),
        jnp.asarray(c)))


def test_forward_local_conditioning():
    cfg_j = jwn.WavenetConfig(num_blocks=1, num_layers=2,
                              residual_channels=8, gate_channels=12,
                              skip_channels=8, cout_channels=20,
                              front_kernel=4, local=True)
    cfg_t = twn.WavenetConfig(**{f: getattr(cfg_j, f) for f in
                                 cfg_j.__dataclass_fields__})
    params = jwn.init_wavenet(jax.random.PRNGKey(1), cfg_j)
    model = weights.wavenet_from_params(_np(params), cfg_t)
    x, c, periods = _inputs(8, frames=2)
    _close(twn.forward(model, cfg_t, _t(x), _t(periods), _t(c)),
           _JFORWARD(params, cfg_j, jnp.asarray(x), jnp.asarray(periods),
                       jnp.asarray(c)))


def test_receptive_field_and_dilations():
    assert twn.dilations(TCFG) == jwn.dilations(JCFG)
    assert twn.receptive_field_size(TCFG) == jwn.receptive_field_size(JCFG)
    full = twn.WavenetConfig()
    assert twn.receptive_field_size(full) == jwn.receptive_field_size(
        jwn.WavenetConfig())


def test_generate_lpc_matches_jax_with_its_eps(wavenet):
    """320 samples at non-zero LPC and de-emphasis 0.85, JAX's eps
    injected: rtol 1e-4, atol 1e-5."""
    params, model = wavenet
    rng = np.random.RandomState(9)
    b, frames = 2, 2
    t = frames * 160
    _, c, periods = _inputs(9, b=b, frames=frames)
    lpc = (rng.randn(b, frames, 16) * 0.05).astype(np.float32)
    lpc_sample = np.repeat(lpc, 160, axis=1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jwn.generate_lpc(
        params, JCFG, key, jnp.asarray(c), jnp.asarray(periods),
        jnp.asarray(lpc_sample), deemphasis=0.85))
    eps = np.asarray(jax.random.normal(key, (t, b)))
    got = twn.generate_lpc(model, TCFG, _t(c), _t(periods), _t(lpc_sample),
                           deemphasis=0.85, eps=_t(eps))
    assert tuple(got.shape) == (b, t)
    assert np.abs(want).max() > 0.1
    _close(got, want, rtol=1e-4, atol=1e-5)


def test_generate_lpc_sampling_identity(wavenet, monkeypatch):
    """The generated signal against its distributions recomputed in
    parallel (lpc 0, de-emphasis 0): `generation_dists` gives each draw's
    x[t] = mean_t + std_t eps[t] at every t (rtol 1e-4, atol 1e-5).  The
    contract of tests/test_wavenet.py:62-86 (forward on y, rtol 1e-2,
    atol 2e-3) holds but where generation's step-0 states stand in for
    forward's zero padding: there the gap is JAX's own, the JAX generator
    given the same eps missing the contract by the same amount (within
    1e-4).  The generator's draws repeat."""
    params, model = wavenet
    b, frames = 2, 2
    t = frames * 160
    _, c, periods = _inputs(10, b=b, frames=frames)
    lpc_sample = torch.zeros((b, t, 16))
    y = twn.generate_lpc(model, TCFG, _t(c), _t(periods), lpc_sample,
                         deemphasis=0.0,
                         generator=torch.Generator().manual_seed(3))
    eps = torch.randn((t, b), generator=torch.Generator().manual_seed(3)).T
    dist = twn.generation_dists(model, TCFG, y, _t(c), _t(periods))
    _close(y, dist[:, 0] + torch.exp(dist[:, 1]) * eps, rtol=1e-4,
           atol=1e-5)

    def contract_gap(y, out):
        out = np.asarray(out)
        want = out[:, 0, :-1] + np.exp(out[:, 1, :-1]) * eps.numpy()[:, 1:]
        return np.abs(np.asarray(y)[:, 1:] - want), np.abs(want)

    gap, ref = contract_gap(y, twn.forward(model, TCFG, y[:, None, :],
                                           _t(periods), _t(c)))
    miss = gap > 2e-3 + 1e-2 * ref
    if miss.any():
        # JAX's generator, its eps replaced by the port's draws
        monkeypatch.setattr(jax.random, "normal", lambda key, shape:
                            jnp.asarray(eps.numpy().T))
        y_j = np.asarray(jwn.generate_lpc(
            params, JCFG, jax.random.PRNGKey(0), jnp.asarray(c),
            jnp.asarray(periods), jnp.asarray(lpc_sample.numpy()),
            deemphasis=0.0))
        monkeypatch.undo()
        gap_j, _ = contract_gap(y_j, _JFORWARD(
            params, JCFG, jnp.asarray(y_j[:, None, :]),
            jnp.asarray(periods), jnp.asarray(c)))
        np.testing.assert_allclose(gap[miss], gap_j[miss], atol=1e-4)
    assert miss.sum() <= 4, np.argwhere(miss)
    again = twn.generate_lpc(model, TCFG, _t(c), _t(periods), lpc_sample,
                             deemphasis=0.0,
                             generator=torch.Generator().manual_seed(3))
    assert torch.equal(y, again)


# ---------------------------------------------------------------- IAF

def test_iaf_matches_jax():
    cfg_j = jiaf.IAFConfig(**ICFG)
    params = jiaf.init_iaf(jax.random.PRNGKey(1), cfg_j)
    model = weights.iaf_from_params(_np(params))
    assert model.cfg == tiaf.IAFConfig(**ICFG)
    rng = np.random.RandomState(11)
    z = (rng.randn(2, 1, 300) * 0.5).astype(np.float32)
    c = (rng.randn(2, 12, 300) * 0.3).astype(np.float32)
    want = jiaf.iaf(params, cfg_j, jnp.asarray(z), jnp.asarray(c))
    got = tiaf.iaf(model, model.cfg, _t(z), _t(c))
    for g, w, shape in zip(got, want, [(2, 1, 300), (2, 1, 299),
                                       (2, 1, 299)]):
        assert tuple(g.shape) == shape
        _close(g, w)
    _close(tiaf.generate(model, model.cfg, _t(z), _t(c)),
           jiaf.generate(params, cfg_j, jnp.asarray(z), jnp.asarray(c)))


# ---------------------------------------------------------------- para

PCFG = dict(gru_units1=24, gru_units2=12)


@pytest.fixture(scope="module")
def para():
    params = jpara.init_para(jax.random.PRNGKey(4), jpara.ParaConfig(**PCFG))
    return params, weights.para_from_params(_np(params))


def _feat(seed, b=2, length=12):
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(b, length, 20).astype(np.float32) * 0.1, 1)


def test_para_forward(para):
    params, model = para
    feat = _feat(12)
    want = jpara.forward(params, jnp.asarray(feat))
    got = tpara.forward(model, _t(feat))
    for g, w in zip(got, want):
        _close(g, w)


def _books(seed):
    rng = np.random.RandomState(seed)
    return dict(scl=(rng.randn(8) * 0.2).astype(np.float32),
                vq=[(rng.randn(16, 17) * 0.1).astype(np.float32),
                    (rng.randn(8, 17) * 0.05).astype(np.float32)],
                scl_bl=(rng.randn(4) * 0.05).astype(np.float32),
                vq_bl=[(rng.randn(8, 17) * 0.03).astype(np.float32)])


def _compare_enc(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "indices":
            assert set(got[k]) == set(w)
            for s, wi in w.items():
                np.testing.assert_array_equal(got[k][s].numpy(),
                                              np.asarray(wi))
        elif np.asarray(w).dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            _close(got[k], w)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("books", [None, "above", "both"])
def test_para_encoder(para, mask, books):
    params, model = para
    feat = _feat(13)
    rng = np.random.RandomState(14)
    m = (rng.rand(2, 12, 2) > 0.4).astype(np.float32) if mask else None
    kw_j = dict(l1=0.05, l2=6.0, qtz=books is not None,
                mask=None if m is None else jnp.asarray(m))
    kw_t = dict(l1=0.05, l2=6.0, qtz=books is not None,
                mask=None if m is None else _t(m))
    if books is not None:
        bk = _books(15)
        if books == "above":
            bk.update(scl_bl=None, vq_bl=None)
        kw_j["codebooks"] = JCodebooks(
            scl=jnp.asarray(bk["scl"]),
            vq=tuple(map(jnp.asarray, bk["vq"])),
            scl_bl=None if bk["scl_bl"] is None else jnp.asarray(
                bk["scl_bl"]),
            vq_bl=None if bk["vq_bl"] is None else tuple(
                map(jnp.asarray, bk["vq_bl"])))
        kw_t["codebooks"] = Codebooks(
            scl=_t(bk["scl"]), vq=tuple(map(_t, bk["vq"])),
            scl_bl=None if bk["scl_bl"] is None else _t(bk["scl_bl"]),
            vq_bl=None if bk["vq_bl"] is None else tuple(
                map(_t, bk["vq_bl"])))
    want = jpara.encoder(params, jnp.asarray(feat), **kw_j)
    with torch.no_grad():
        got = tpara.encoder(model, _t(feat), **kw_t)
    ind = np.asarray(want["ind1"]), np.asarray(want["ind2"])
    assert ind[0].any() and not ind[0].all()
    assert ind[1].any() and not ind[1].all()
    _compare_enc(got, want)


# ---------------------------------------------------------------- attention

@pytest.fixture(scope="module")
def attn():
    params = jatt.init_location_attention(jax.random.PRNGKey(2), 16)
    return params, weights.attention_from_params(_np(params))


@pytest.mark.parametrize("smoothing", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_attend(attn, smoothing, masked):
    params, model = attn
    rng = np.random.RandomState(16)
    x = rng.randn(2, 12, 16).astype(np.float32)
    last = rng.rand(2, 12).astype(np.float32)
    mask = (np.arange(12)[None, :] < np.array([[9], [5]])) if masked \
        else None
    want = jatt.attend(params, jnp.asarray(x[:, 3:4]), jnp.asarray(x),
                       jnp.asarray(last),
                       mask=None if mask is None else jnp.asarray(mask),
                       smoothing=smoothing)
    got = tatt.attend(model, _t(x[:, 3:4]), _t(x), _t(last),
                      mask=None if mask is None else _t(mask),
                      smoothing=smoothing)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("smoothing", [True, False])
def test_loop_attention(attn, smoothing):
    params, model = attn
    x = np.random.RandomState(17).randn(2, 12, 16).astype(np.float32)
    _close(tatt.loop_attention(model, _t(x), attn_range=4,
                               smoothing=smoothing),
           jatt.loop_attention(params, jnp.asarray(x), attn_range=4,
                               smoothing=smoothing))
