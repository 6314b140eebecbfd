"""The port's WaveNet-family trainers and synthesis against JAX's.

fpsc_tpu_torch/train/train_vocoder.py, train_iaf.py, train_all.py and
synthesis.py against their fpsc_tpu twins at the small widths of
tests/test_entries.py::_tiny_cfg, the JAX parameters carried across by
train/weights.py, the inputs numpy from a seed (B=2, one chunk of 2400
samples).  Tolerances: each loss rtol 1e-5, each gradient leaf within
1e-5 of its largest element against jax.grad; the IAF's noise and the
coded features' periods are JAX's (z injected; the periods equal, or a
difference counted as a knife edge of the truncation).  Beside them:
upd_f_only, the four entry points on the CPU, and checkpoints that each
package writes and the other loads.
"""
import glob
import os
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.models import wavenet as jwn
from fpsc_tpu.models import wavenet_iaf as jiaf
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import train_all as jta
from fpsc_tpu.train import train_frame as jtf
from fpsc_tpu.train import train_iaf as jti
from fpsc_tpu.train import train_vocoder as jtv

from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.models import frame_predictor as tfp
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.train import synthesis as tsyn
from fpsc_tpu_torch.train import train_all as tta
from fpsc_tpu_torch.train import train_iaf as tti
from fpsc_tpu_torch.train import train_vocoder as ttv
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


TINY = [
    "data.synthetic=true", "data.synthetic_utterances=2",
    "data.chunks=1", "data.batch_size=2",
    "wavenet.num_blocks=1", "wavenet.num_layers=2",
    "wavenet.residual_channels=8", "wavenet.gate_channels=12",
    "wavenet.skip_channels=8", "wavenet.cout_channels=12",
    "wavenet.front_kernel=4",
    "iaf.num_flows=2", "iaf.num_layers=2",
    "iaf.residual_channels=8", "iaf.gate_channels=12",
    "iaf.skip_channels=8", "iaf.cout_channels=12",
    "predictor.gru_units1=16", "predictor.gru_units2=8",
    "train.epochs=1", "train.debugging=true",
]


def _cfgs(tmp_path, extra=()):
    over = [*TINY, f"train.save_dir={tmp_path}", *extra]
    jcfg, tcfg = JConfig(), Config()
    japply(jcfg, over)
    apply_overrides(tcfg, over)
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _batch(seed, b=2, frames=15):
    """feat (B, L, 20) normalised, periods, x (B, L * 160), lpc (B, L,
    16): a random walk for the signal, small LPC (a stable synthesis
    filter)."""
    rng = np.random.RandomState(seed)
    t = frames * 160
    feat = (rng.randn(b, frames, 20) * 0.3).astype(np.float32)
    periods = rng.randint(32, 256, (b, frames)).astype(np.int32)
    x = (np.cumsum(rng.randn(b, t), 1) * 0.01).astype(np.float32)
    lpc = (rng.randn(b, frames, 16) * 0.04).astype(np.float32)
    return feat, periods, x, lpc


def _grads_close(model, jax_grads, rtol=1e-5):
    named = dict(model.named_parameters())
    leaves = weights.flatten(_np(jax_grads))
    assert len(leaves) == len(named)
    for path, want in leaves:
        got = named[path].grad
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= rtol * scale, (
            path, float(np.abs(got - want).max()), scale)


def _value_and_grad(model, loss, *args, **kw):
    model.zero_grad(set_to_none=True)
    value = loss(model, *args, **kw)
    value.backward()
    return float(value.detach())


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("inp_channels", [1, 3])
def test_vocoder_loss_and_gradients(tmp_path, inp_channels):
    jcfg, tcfg = _cfgs(tmp_path, [f"wavenet.inp_channels={inp_channels}"])
    jm, tm = jtv.model_config(jcfg), ttv.model_config(tcfg)
    params = jwn.init_wavenet(jax.random.PRNGKey(1), jm)
    model = weights.wavenet_from_params(_np(params), tm)
    feat, periods, x, lpc = _batch(1)
    want, grads = jax.jit(jax.value_and_grad(jtv.loss_fn),
                          static_argnums=(1, 6))(
        params, jm, *map(jnp.asarray, (feat, periods, x, lpc)),
        inp_channels)
    got = _value_and_grad(model, ttv.loss_fn, tm, *map(_t, (feat, periods,
                                                           x, lpc)),
                          inp_channels)
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, want)
    _grads_close(model, grads)


@pytest.mark.parametrize("distill", [0.0, 0.1])
def test_iaf_loss_and_gradients(tmp_path, distill):
    """z injected (JAX's draws); the distillation term through the LPC
    synthesis filter and the frozen teacher's forward."""
    jcfg, tcfg = _cfgs(tmp_path)
    jm, tm = jtv.model_config(jcfg), ttv.model_config(tcfg)
    ji, ti = jti.iaf_config(jcfg), tti.iaf_config(tcfg)
    teacher_p = jwn.init_wavenet(jax.random.PRNGKey(9), jm)
    params = jiaf.init_iaf(jax.random.PRNGKey(2), ji)
    teacher = weights.wavenet_from_params(_np(teacher_p),
                                          tm).requires_grad_(False)
    model = weights.iaf_from_params(_np(params))
    assert model.cfg == ti
    feat, periods, x, lpc = _batch(2)
    key = jax.random.PRNGKey(5)
    want, grads = jax.jit(jax.value_and_grad(jti.loss_fn),
                          static_argnums=(1, 4),
                          static_argnames=("distill_weight",))(
        params, ji, key, teacher_p, jm,
        *map(jnp.asarray, (feat, periods, x, lpc)), distill_weight=distill)
    z = np.asarray(jax.random.normal(key, x.shape))
    got = _value_and_grad(model, tti.loss_fn, ti, teacher, tm,
                          *map(_t, (feat, periods, x, lpc)),
                          distill_weight=distill, z=_t(z))
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, want)
    _grads_close(model, grads)
    assert all(p.grad is None for p in teacher.parameters())


def test_iaf_kl_closed_form():
    """tests/test_wavenet.py::test_kl_gaussians_closed_form on the
    port's train_iaf.kl_gaussians (floor -9, the mean)."""
    mu, logs = torch.tensor([0.3, -1.0]), torch.tensor([-0.5, 0.2])
    assert abs(float(tti.kl_gaussians(mu, logs, mu, logs))) < 1e-7
    got = float(tti.kl_gaussians(mu, logs, torch.zeros(2), torch.zeros(2)))
    var_q = np.exp(2 * logs.numpy())
    want = np.mean(-logs.numpy() + (var_q + mu.numpy() ** 2) / 2.0 - 0.5)
    assert abs(got - want) < 1e-6
    lo = torch.tensor([-12.0])
    assert float(tti.kl_gaussians(mu[:1], lo, mu[:1], lo)) == 0.0


def test_train_all_step_loss_and_gradients(tmp_path):
    """The frozen predictor's coded features, their periods and the
    vocoder's loss and gradients of one train_all step."""
    jcfg, tcfg = _cfgs(tmp_path)
    jm, tm = jtv.model_config(jcfg), ttv.model_config(tcfg)
    frame_p = jtf.build_model(jcfg, jax.random.PRNGKey(3))
    sample_p = jwn.init_wavenet(jax.random.PRNGKey(4), jm)
    frame = weights.predictor_from_params(_np(frame_p))
    sample = weights.wavenet_from_params(_np(sample_p), tm)
    rng = np.random.RandomState(6)
    _, _, x, lpc = _batch(6)
    nm_feat = np.cumsum(rng.randn(2, 15, 20).astype(np.float32) * 0.05, 1)
    l1, l2 = tcfg.codec.l1, tcfg.codec.l2
    coded_j = jta.coded_features(frame_p, jnp.asarray(nm_feat), l1, l2)
    periods_j = np.asarray((0.1 + 50.0 * coded_j[..., 18] + 100.0).astype(
        jnp.int32))
    coded = tta.coded_features(frame, _t(nm_feat), l1, l2)
    np.testing.assert_allclose(coded.numpy(), np.asarray(coded_j),
                               rtol=1e-5, atol=1e-5)
    periods = tta.coded_periods(coded).numpy()
    value = 0.1 + 50.0 * np.asarray(coded_j, np.float64)[..., 18] + 100.0
    knife = np.abs(value - np.round(value)) < 1e-4
    assert np.all((periods == periods_j) | knife)

    def jloss(sp):
        return jtv.loss_fn(sp, jm, coded_j[..., :20] / jta.C.MAXI,
                           jnp.asarray(periods_j), jnp.asarray(x),
                           jnp.asarray(lpc))

    want, grads = jax.jit(jax.value_and_grad(jloss))(sample_p)
    got = _value_and_grad(sample, tta.vocoder_loss, tm, frame, l1, l2, 1,
                          _t(nm_feat), _t(x), _t(lpc))
    assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, want)
    _grads_close(sample, grads)
    assert all(p.grad is None for p in frame.parameters())


# ---------------------------------------------------------------- optimizer

def test_upd_f_only_trains_the_upsampler_alone(tmp_path):
    """tests/test_entries.py:38-63 on the port: after a step the core is
    unchanged and the upsampler moved; the optimizer holds the
    upsampler's leaves alone, in JAX's order, so the clip's global norm
    counts their gradients only (optax's multi_transform), as JAX's
    update shows at a clip that binds."""
    jcfg, tcfg = _cfgs(tmp_path, ["train.upd_f_only=true",
                                  "train.grad_clip=1e-3"])
    jm, tm = jtv.model_config(jcfg), ttv.model_config(tcfg)
    params = jwn.init_wavenet(jax.random.PRNGKey(0), jm)
    model = weights.wavenet_from_params(_np(params), tm)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = ttv.build_optimizer(tcfg, model)
    ups = [n for n, _ in weights.named_leaves(model)
           if n.startswith("upsampler.")]
    assert [n for n, _ in ttv.trained_parameters(model, True)] == ups
    feat, periods, x, lpc = _batch(7, b=1, frames=2)
    step = ttv.make_step(opt, ttv.loss_fn, tm)
    step(model, *map(_t, (feat, periods, x, lpc)), 1)
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        assert same == (not n.startswith("upsampler.")), n
    assert not torch.equal(model.upsampler.c_conv1.v, before[
        "upsampler.c_conv1.v"])
    # the clipped gradients against optax's, the norm over the upsampler
    tx = jtv.build_optimizer(jcfg, params)
    grads = jax.jit(jax.grad(jtv.loss_fn), static_argnums=(1,))(
        params, jm, *map(jnp.asarray, (feat, periods, x, lpc)))
    clipped = optax.clip_by_global_norm(1e-3).update(grads.upsampler,
                                                     None)[0]
    norm = float(optax.global_norm(grads.upsampler))
    assert norm > 1e-3
    got = opt.clip([p.grad for p in opt.params])
    for g, (path, w) in zip(got, weights.flatten(_np(clipped))):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=path)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    assert all(float(jnp.abs(u).max()) == 0.0 for u in
               jax.tree_util.tree_leaves(updates._replace(upsampler=None)))


# ---------------------------------------------------------------- entries

def test_train_vocoder_entry(tmp_path):
    _, tcfg = _cfgs(tmp_path)
    model, loss = ttv.run(tcfg, device="cpu")
    assert np.isfinite(loss)
    assert ttv.main([*TINY, f"train.save_dir={tmp_path}",
                     "--device=cpu"]) == 0


def test_train_iaf_entry(tmp_path):
    _, tcfg = _cfgs(tmp_path)
    model, loss = tti.run(tcfg, device="cpu")
    assert np.isfinite(loss)
    _, tcfg = _cfgs(tmp_path, ["iaf.distill_weight=0.1"])
    with pytest.raises(ValueError, match="requires train.transfer_model"):
        tti.run(tcfg, device="cpu")


def test_train_all_entry(tmp_path):
    _, tcfg = _cfgs(tmp_path)
    frame, sample, loss = tta.run(tcfg, device="cpu")
    assert np.isfinite(loss)
    assert not any(p.requires_grad for p in frame.parameters())


def test_synthesis_entry(tmp_path):
    _, tcfg = _cfgs(tmp_path)
    outs = tsyn.run(tcfg, num_samples=1, out_dir=str(tmp_path / "wav"),
                    device="cpu")
    assert len(outs) == 1
    name, y = outs[0]
    assert y.shape == (1, 2400) and np.isfinite(y).all()
    wavs = sorted(glob.glob(str(tmp_path / "wav" / "*.wav")))
    assert [os.path.basename(w) for w in wavs] == [f"{name}_truth.wav",
                                                   f"{name}_xout.wav"]
    for w in wavs:
        with wave.open(w) as f:
            assert f.getframerate() == 16000 and f.getnframes() == 2400


def test_synthesis_with_injected_eps(tmp_path):
    """eps(samples, 1) is called once an utterance; the default draws of
    utterance ns are torch.Generator().manual_seed(ns)'s."""
    _, tcfg = _cfgs(tmp_path)
    calls = []

    def eps(t, b):
        calls.append((t, b))
        return torch.randn((t, b), generator=torch.Generator().manual_seed(
            len(calls) - 1))

    got = tsyn.run(tcfg, num_samples=2, out_dir=str(tmp_path / "a"),
                   device="cpu", eps=eps)
    want = tsyn.run(tcfg, num_samples=2, out_dir=str(tmp_path / "b"),
                    device="cpu")
    assert calls == [(2400, 1), (2400, 1)]
    for (n1, y1), (n2, y2) in zip(got, want):
        assert n1 == n2
        np.testing.assert_array_equal(y1, y2)


# ---------------------------------------------------------------- checkpoints

def _leaves_equal(tree, module):
    named = dict(module.named_parameters())
    leaves = weights.flatten(_np(tree))
    assert len(leaves) == len(named)
    for path, leaf in leaves:
        np.testing.assert_array_equal(named[path].detach().numpy(), leaf,
                                      err_msg=path)


def test_port_checkpoints_load_in_jax(tmp_path):
    """Each entry's checkpoint, written by the port, read by JAX's load
    and restore_params into JAX's template."""
    jcfg, tcfg = _cfgs(tmp_path, ["train.debugging=false",
                                  "train.steps_per_epoch=1",
                                  "label=port"])
    jm = jtv.model_config(jcfg)

    def restored(label, template):
        payload = jckpt.load(jckpt.checkpoint_path(str(tmp_path), label, 0))
        return jckpt.restore_params(template, payload, label)

    voc, _ = ttv.run(tcfg, device="cpu")
    _leaves_equal(restored("port_s", jwn.init_wavenet(
        jax.random.PRNGKey(0), jm)), voc)
    student, _ = tti.run(tcfg, device="cpu")
    _leaves_equal(restored("port_iaf", jiaf.init_iaf(
        jax.random.PRNGKey(0), jti.iaf_config(jcfg))), student)
    # train_all's pair
    frame, sample, _ = tta.run(tcfg, device="cpu")
    _leaves_equal(restored("port_f", jtf.build_model(
        jcfg, jax.random.PRNGKey(0))), frame)
    _leaves_equal(restored("port_s", jwn.init_wavenet(
        jax.random.PRNGKey(0), jm)), sample)


def test_jax_checkpoints_load_in_the_port(tmp_path):
    """JAX's checkpoints of each entry's model, read by the port: the
    vocoder as train_vocoder's transfer model, synthesis' WaveNet and
    train_iaf's teacher; the IAF student; train_all's predictor."""
    jcfg, tcfg = _cfgs(tmp_path, ["train.transfer_model=jax_s",
                                  "train.transfer_epoch=0"])
    jm, tm = jtv.model_config(jcfg), ttv.model_config(tcfg)
    voc = jwn.init_wavenet(jax.random.PRNGKey(11), jm)
    jckpt.save(jckpt.checkpoint_path(str(tmp_path), "jax_s", 0), voc,
               step=0)
    student = jiaf.init_iaf(jax.random.PRNGKey(12), jti.iaf_config(jcfg))
    jckpt.save(jckpt.checkpoint_path(str(tmp_path), "jax_iaf", 0), student)
    frame = jtf.build_model(jcfg, jax.random.PRNGKey(13))
    jckpt.save(jckpt.checkpoint_path(str(tmp_path), "jax_f", 0), frame)

    def load(label):
        return tckpt.load(tckpt.checkpoint_path(str(tmp_path), label, 0))

    from fpsc_tpu_torch.models import wavenet as twn
    from fpsc_tpu_torch.models import wavenet_iaf as tiaf
    _leaves_equal(voc, tckpt.restore(twn.Wavenet(tm), load("jax_s")))
    _leaves_equal(student, tckpt.restore(tiaf.IAF(tti.iaf_config(tcfg)),
                                         load("jax_iaf")))
    _leaves_equal(frame, tckpt.restore(tfp.FramePredictor(
        tfp.FramePredictorConfig(gru_units1=16, gru_units2=8),
        torch.Generator()), load("jax_f")))
    _leaves_equal(voc, tti.load_teacher(tcfg, "cpu"))
    outs = tsyn.run(tcfg, num_samples=1, out_dir=str(tmp_path / "wav"),
                    device="cpu")
    assert np.isfinite(outs[0][1]).all()
    model, _ = ttv.run(apply_overrides(
        tcfg, ["train.epochs=1", "train.learning_rate=0"]), device="cpu")
    _leaves_equal(voc, model)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore(twn.Wavenet(twn.WavenetConfig()), load("jax_s"),
                      "WaveNet")
