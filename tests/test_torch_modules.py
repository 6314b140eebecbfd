"""Parity of the PyTorch port's decode-path modules with the JAX package.

Inputs are made with numpy from a seed and given to both sides; JAX
runs on the CPU (tests/conftest.py), the port with device="cpu".
Tolerances: f32 layers rtol 1e-5, atol 1e-6 (the same f32 arithmetic,
summed in another order); ceps2lpc rtol 1e-4, atol 1e-5 (`10**x` and
the irfft round differently); the closed-loop decode rtol 1e-4, atol
1e-5, as tests/test_file_codec.py:131 uses.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.codec import codec as jcodec
from fpsc_tpu.dsp import ceps2lpc as jceps
from fpsc_tpu.dsp import mulaw as jmulaw
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import gru as jgru
from fpsc_tpu.models import lpcnet as jlpcnet

from fpsc_tpu_torch.codec import codec as tcodec
from fpsc_tpu_torch.dsp import ceps2lpc as tceps
from fpsc_tpu_torch.dsp import mulaw as tmulaw
from fpsc_tpu_torch.models import frame_predictor as tfp
from fpsc_tpu_torch.models import gru as tgru
from fpsc_tpu_torch.models import lpcnet as tlpcnet
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


F32 = dict(rtol=1e-5, atol=1e-6)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_mulaw_matches_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4000) * 3000.0,
                        rng.uniform(-32768, 32767, 4000), [0.0]])
    x = x.astype(np.float32)
    np.testing.assert_allclose(tmulaw.l2u(_t(x)).numpy(),
                               np.asarray(jmulaw.l2u(jnp.asarray(x))), **F32)
    np.testing.assert_array_equal(
        tmulaw.l2u_index(_t(x)).numpy(),
        np.asarray(jmulaw.l2u_index(jnp.asarray(x))))
    codes = np.arange(256)
    np.testing.assert_allclose(
        tmulaw.u2l(_t(codes)).numpy(),
        np.asarray(jmulaw.u2l(jnp.asarray(codes))), rtol=1e-5, atol=1e-3)


def test_gru_step_matches_jax():
    params = jgru.init_gru(jax.random.PRNGKey(1), 20, 24)
    gru = tgru.GRU(20, 24, torch.Generator().manual_seed(1))
    weights.load_into(gru, _np_tree(params), "gru")
    rng = np.random.RandomState(1)
    x = rng.randn(5, 20).astype(np.float32)
    h = rng.randn(5, 24).astype(np.float32) * 0.5
    want = jgru.gru_step(params, jnp.asarray(h), jnp.asarray(x))
    with torch.no_grad():
        got = tgru.gru_step(gru, _t(h), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_frame_net_matches_jax():
    cfg = jlpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8,
                               embed_dim=16, cond_units=24)
    params = jlpcnet.init_lpcnet(jax.random.PRNGKey(2), cfg)
    model = weights.lpcnet_from_params(_np_tree(params))
    rng = np.random.RandomState(2)
    feat = (rng.randn(3, 7, 20) * 0.3).astype(np.float32)
    periods = rng.randint(-5, 600, (3, 7)).astype(np.int32)
    want = jlpcnet.frame_net(params, jnp.asarray(feat), jnp.asarray(periods))
    with torch.no_grad():
        got = tlpcnet.frame_net(model, _t(feat), _t(periods))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_draw_excitation_matches_jax():
    """The sampling tail draws the same mu-law code from the same
    logits, temperatures and uniforms: F32, the cdf summed in the same
    Hillis-Steele order."""
    rng = np.random.RandomState(8)
    logits = rng.uniform(-2.0, 2.0, (64, 256)).astype(np.float32)
    temp = rng.uniform(1.0, 1.25, (64, 1)).astype(np.float32)
    u = rng.uniform(size=(64, 1)).astype(np.float32)
    table = np.array(jmulaw.u2l(jnp.arange(256)) / 32768.0)
    want = jlpcnet.draw_excitation(jnp.asarray(logits), jnp.asarray(temp),
                                   jnp.asarray(u), jnp.asarray(table))
    got = tlpcnet.draw_excitation(_t(logits), _t(temp), _t(u), _t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ceps2lpc_matches_jax():
    rng = np.random.RandomState(3)
    # speech-scale cepstra: c0 spans quiet to loud frames (near-singular
    # autocorrelations from far larger cepstra are ill-conditioned, and
    # any two f32 Levinson implementations part there)
    ceps = rng.randn(64, 18).astype(np.float32)
    ceps[:, 0] += rng.uniform(-12.0, 4.0, 64).astype(np.float32)
    ceps[0] = 0.0
    want = [np.asarray(a) for a in jceps.ceps2lpc(jnp.asarray(ceps))]
    got = [a.numpy() for a in tceps.ceps2lpc(_t(ceps))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def _codebooks(rng, with_bl):
    books = jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(16)).astype(np.float32) * 0.1),
        vq=(jnp.asarray(rng.randn(32, 17).astype(np.float32) * 0.1),
            jnp.asarray(rng.randn(16, 17).astype(np.float32) * 0.03)),
        scl_bl=(jnp.asarray(rng.randn(4).astype(np.float32) * 0.02)
                if with_bl else None),
        vq_bl=((jnp.asarray(rng.randn(8, 17).astype(np.float32) * 0.02),)
               if with_bl else None))
    return books, weights.codebooks_from_tree(_np_tree(books))


def _streams(rng, b, length):
    ind1 = rng.rand(b, length) > 0.5
    ind2 = rng.rand(b, length) > 0.4
    idx = {"scl": np.where(ind1, rng.randint(0, 16, (b, length)), -1),
           "scl_bl": np.where(ind1, -1, rng.randint(0, 4, (b, length))),
           "vq": np.where(ind2[..., None],
                          np.stack([rng.randint(0, 32, (b, length)),
                                    rng.randint(0, 16, (b, length))], -1),
                          -1),
           "vq_bl": np.where(ind2[..., None],
                             -1, rng.randint(0, 8, (b, length, 1)))}
    idx = {k: v.astype(np.int32) for k, v in idx.items()}
    pitch = np.stack([rng.uniform(-1.4, 3.7, (b, length)),
                      rng.uniform(-0.5, 0.5, (b, length))], -1)
    return ind1, ind2, idx, (pitch / 24.1).astype(np.float32)


@pytest.mark.parametrize("with_bl", [True, False])
def test_dequantize_residual_matches_jax(with_bl):
    rng = np.random.RandomState(4)
    jbooks, tbooks = _codebooks(rng, with_bl)
    ind1, ind2, idx, _ = _streams(rng, 3, 9)
    want = jcodec.dequantize_residual(
        jbooks, jnp.asarray(ind1), jnp.asarray(ind2),
        {k: jnp.asarray(v) for k, v in idx.items()})
    got = tcodec.dequantize_residual(
        tbooks, _t(ind1), _t(ind2), {k: _t(v).long() for k, v in idx.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _predictor(seed=5):
    cfg = jfp.FramePredictorConfig(gru_units1=32, gru_units2=16)
    params = jfp.init_frame_predictor(jax.random.PRNGKey(seed), cfg)
    return params, weights.predictor_from_params(_np_tree(params))


@pytest.mark.parametrize("pitch_lag", [0, 1])
def test_frame_predictor_decoder_matches_jax(pitch_lag):
    params, model = _predictor()
    rng = np.random.RandomState(6)
    pitch = (rng.randn(4, 12, 2) * 0.05).astype(np.float32)
    r = (rng.randn(4, 12, 18) * 0.1).astype(np.float32)
    want = jfp.decoder(params, jnp.asarray(pitch), jnp.asarray(r),
                       pitch_lag=pitch_lag)
    with torch.no_grad():
        got = tfp.decoder(model, _t(pitch), _t(r), pitch_lag=pitch_lag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_codec_decode_matches_jax():
    params, model = _predictor(7)
    rng = np.random.RandomState(7)
    jbooks, tbooks = _codebooks(rng, True)
    ind1, ind2, idx, pitch = _streams(rng, 3, 15)
    want = jcodec.decode(params, jbooks, jnp.asarray(ind1),
                         jnp.asarray(ind2),
                         {k: jnp.asarray(v) for k, v in idx.items()},
                         jnp.asarray(pitch))
    got = tcodec.decode(model, tbooks, _t(ind1), _t(ind2),
                        {k: _t(v).long() for k, v in idx.items()},
                        _t(pitch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
