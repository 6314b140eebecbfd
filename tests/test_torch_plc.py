"""The port's packet-loss concealment against the JAX package's.

fpsc_tpu_torch/codec/plc.py ports conceal_decode, conceal_decode_residual
and fec_merge_residual (its frame loop replaces JAX's lax.scan) and the
numpy loss masks.  The same seeded predictor, codebooks, symbols and
loss masks go through both; coded frames are held at rtol 1e-4, atol
1e-5, the closed-loop tolerance of tests/test_file_codec.py:131.  Loss
patterns: none (which must give codec.decode's frames exactly), iid,
bursts and every frame lost; options: damp 0, 0.5 and 1, freeze, no
energy cap, an early and steep fade.  fec_merge_residual and the masks
are exact.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fpsc_tpu.codec import bitstream as jbs
from fpsc_tpu.codec import codec as jcodec
from fpsc_tpu.codec import plc as jplc
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.codec import rate_control as jrate
from fpsc_tpu.models import frame_predictor as jfp

from fpsc_tpu_torch.codec import codec as tcodec
from fpsc_tpu_torch.codec import plc as tplc
from fpsc_tpu_torch.codec import rate_control as trate
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads

B, L = 3, 24
CLOSED_LOOP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _t(x):
    return torch.as_tensor(np.array(x))


def _predictor(seed=5):
    params = jfp.init_frame_predictor(
        jax.random.PRNGKey(seed),
        jfp.FramePredictorConfig(gru_units1=32, gru_units2=16))
    return params, weights.predictor_from_params(_np_tree(params))


def _codebooks(rng):
    books = jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(16)).astype(np.float32) * 0.1),
        vq=(jnp.asarray(rng.randn(32, 17).astype(np.float32) * 0.1),
            jnp.asarray(rng.randn(16, 17).astype(np.float32) * 0.03)),
        scl_bl=jnp.asarray(np.sort(rng.randn(4)).astype(np.float32) * 0.02),
        vq_bl=(jnp.asarray(rng.randn(8, 17).astype(np.float32) * 0.02),))
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


def _loss(kind, rng):
    if kind == "none":
        return np.zeros((B, L), bool)
    if kind == "iid":
        return tplc.random_loss_mask(rng, B, L, 0.3)
    if kind == "burst":
        return tplc.burst_loss_mask(rng, B, L, 0.3, mean_burst=4.0)
    return np.ones((B, L), bool)


LOSSES = ["none", "iid", "burst", "all"]
OPTIONS = {"default": {}, "damp_half": dict(damp=0.5),
           "damp_one": dict(damp=1.0), "freeze": dict(freeze=True),
           "no_energy_cap": dict(energy_cap=False),
           "steep_fade": dict(fade_after=0, fade_step=0.05)}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("loss", LOSSES)
def test_conceal_decode_matches_jax(loss, option):
    params, model = _predictor()
    rng = np.random.RandomState(LOSSES.index(loss) + 3)
    jbooks, tbooks = _codebooks(rng)
    ind1, ind2, idx, pitch = _streams(rng, B, L)
    lost = _loss(loss, rng)
    if loss in ("iid", "burst"):
        assert lost.any() and not lost.all()
    kw = OPTIONS[option]
    want = jplc.conceal_decode(params, jbooks, jnp.asarray(ind1),
                               jnp.asarray(ind2),
                               {k: jnp.asarray(v) for k, v in idx.items()},
                               jnp.asarray(pitch), jnp.asarray(lost), **kw)
    got = tplc.conceal_decode(model, tbooks, _t(ind1), _t(ind2),
                              {k: _t(v).long() for k, v in idx.items()},
                              _t(pitch), _t(lost), **kw)
    assert got.shape == (B, L, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSED_LOOP)
    if loss == "none":
        plain = tcodec.decode(model, tbooks, _t(ind1), _t(ind2),
                              {k: _t(v).long() for k, v in idx.items()},
                              _t(pitch))
        np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("damp", [0.0, 1.0])
def test_conceal_decode_residual_matches_jax(damp):
    """The FEC entry, on residuals given directly; damp=0 takes 0 ** 0
    as 1 on the first lost frame of a run and 0 after it."""
    params, model = _predictor(6)
    rng = np.random.RandomState(8)
    r = (rng.randn(B, L, 18) * 0.1).astype(np.float32)
    pitch = (rng.randn(B, L, 2) * 0.05).astype(np.float32)
    lost = tplc.burst_loss_mask(rng, B, L, 0.4, mean_burst=3.0)
    want = jplc.conceal_decode_residual(params, jnp.asarray(r),
                                        jnp.asarray(pitch),
                                        jnp.asarray(lost), damp=damp)
    got = tplc.conceal_decode_residual(model, _t(r), _t(pitch), _t(lost),
                                       damp=damp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSED_LOOP)
    assert float(torch.pow(torch.tensor(0.0), torch.tensor(0.0))) == 1.0


def test_conceal_decode_with_no_loss_matches_jax_decode():
    params, model = _predictor(7)
    rng = np.random.RandomState(9)
    jbooks, tbooks = _codebooks(rng)
    ind1, ind2, idx, pitch = _streams(rng, B, L)
    want = jcodec.decode(params, jbooks, jnp.asarray(ind1),
                         jnp.asarray(ind2),
                         {k: jnp.asarray(v) for k, v in idx.items()},
                         jnp.asarray(pitch))
    got = tplc.conceal_decode(model, tbooks, _t(ind1), _t(ind2),
                              {k: _t(v).long() for k, v in idx.items()},
                              _t(pitch), torch.zeros(B, L, dtype=torch.bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSED_LOOP)


@pytest.mark.parametrize("drops", [[], [1], [1, 2], [3]])
def test_fec_merge_residual_is_jaxs(drops):
    """JAX's packed FEC stream, unpacked by JAX under drops, merged by
    both: the same residuals, pitch and loss mask, exactly."""
    rng = np.random.RandomState(10)
    jbooks, tbooks = _codebooks(rng)
    jlean = jrate.preset_codebooks(jbooks, **jrate.PRESETS["lean"])
    tlean = trate.preset_codebooks(tbooks, **trate.PRESETS["lean"])
    sizes = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}
    lean_sizes = {"scl": 16, "scl_bl": 4, "vq": [32], "vq_bl": []}
    ind1, ind2, idx, pitch = _streams(rng, 1, 17)
    idx = {k: v[0] for k, v in idx.items()}
    fidx = {"scl": idx["scl"], "scl_bl": idx["scl_bl"],
            "vq": np.where(ind2[0][:, None], rng.randint(0, 32, (17, 1)), -1),
            "vq_bl": np.full((17, 1), -1)}
    pcodes = jbs.quantize_pitch(pitch[0] * 24.1)
    packets = jrc.pack_packets_fec(ind1[0], ind2[0], idx, pcodes, sizes,
                                   fidx, lean_sizes, packet_frames=5)
    payloads = [None if i in drops else p for i, p in enumerate(packets)]
    unpacked = jrc.unpack_packets_fec(payloads, sizes, lean_sizes,
                                      packet_frames=5, total_frames=17)
    want = jplc.fec_merge_residual(jbooks, jlean, unpacked)
    got = tplc.fec_merge_residual(tbooks, tlean, unpacked)
    for g, w in zip(got, want):
        assert g.dtype == _t(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2].any()) == (3 in drops or drops == [1, 2])


@pytest.mark.parametrize("mask", ["random", "burst", "packet"])
def test_loss_masks_are_jaxs(mask):
    make = {"random": lambda m, r: m.random_loss_mask(r, 4, 300, 0.2),
            "burst": lambda m, r: m.burst_loss_mask(r, 3, 400, 0.2, 4.0),
            "packet": lambda m, r: m.packet_loss_mask(r, 500, 0.3)}[mask]
    got = make(tplc, np.random.RandomState(4))
    np.testing.assert_array_equal(got, make(jplc, np.random.RandomState(4)))
    assert got.dtype == bool and got.any() and not got.all()
