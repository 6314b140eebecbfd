"""The port's predictor training against JAX's.

fpsc_tpu_torch/models/frame_predictor.py::forward and
fpsc_tpu_torch/train/train_frame.py (warmup_loss, mask_loss, make_steps,
run) against fpsc_tpu's at the small widths of
tests/test_data_and_train.py::test_train_frame_slice (GRU 32 / 16, the
mask GRUs 18), JAX's weights carried over by weights.predictor_from_params,
inputs numpy from a seed.  Tolerances:

* forward: rtol 1e-5 (atol 1e-6);
* warmup_loss and mask_loss: the value at rtol 1e-5, every gradient leaf
  within 1e-5 of its largest element, against jax.grad;
* two-step trainers (one warm step, one mask step) from the same JAX
  checkpoint on one directory corpus: the logged losses at rtol 1e-5;
  the parameters within 1e-3 lr (+1e-7) of JAX's, except where a step's
  gradient was below 1e-3 of its leaf's largest (Adam's first steps are
  almost sign functions there), counted and printed.
"""
import os
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.data import dataset as jds
from fpsc_tpu.data import f32 as jf32
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import train_frame as jtf

from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.models import frame_predictor as tfp
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.train import train_frame as ttf
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.train.train_lpcnet import ClippedAdam
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


SMALL = ["predictor.gru_units1=32", "predictor.gru_units2=16"]
JCFG = jfp.FramePredictorConfig(gru_units1=32, gru_units2=16)
LR = 1e-3
B, L = 3, 30


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _predictor(seed=3):
    params = jfp.init_frame_predictor(jax.random.PRNGKey(seed), JCFG)
    return params, weights.predictor_from_params(_tree(params))


def _feat(seed=4):
    """(B, L, 20) normalised-scale frames: cepstra and pitch of the size
    the synthetic fixtures give."""
    rng = np.random.RandomState(seed)
    feat = (rng.randn(B, L, 20) * 0.3).astype(np.float32)
    return np.cumsum(feat, axis=1).astype(np.float32) * 0.2


def _close_grads(got: dict, want, tol=1e-5):
    for name, w in weights.flatten(_tree(want)):
        g = got[name]
        # a leaf the loss does not reach has no gradient (JAX: zeros)
        g = np.zeros_like(w) if g is None else weights._jax_layout(
            name, g).numpy()
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol * scale, (
            name, float(np.abs(g - w).max()), scale)


def test_forward_matches_jax():
    params, model = _predictor()
    feat = _feat()
    want = jfp.forward(params, jnp.asarray(feat))
    with torch.no_grad():
        got = tfp.forward(model, torch.as_tensor(feat))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


LOSSES = {"warmup": None, "mask_scale_1": 1.0, "mask_scale_11": 11.0}


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_and_gradients_match_jax(case):
    """The loss value at rtol 1e-5 and its gradients within 1e-5 of each
    leaf's largest element, against jax.value_and_grad."""
    scale = LOSSES[case]
    params, model = _predictor(7)
    feat = _feat(8)
    if scale is None:
        want, want_g = jax.value_and_grad(jtf.warmup_loss)(
            params, jnp.asarray(feat))
        got = ttf.warmup_loss(model, torch.as_tensor(feat))
    else:
        want, want_g = jax.value_and_grad(jtf.mask_loss)(
            params, jnp.asarray(feat), jnp.float32(scale), 0.3)
        got = ttf.mask_loss(model, torch.as_tensor(feat), scale, 0.3)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _close_grads({n: p.grad for n, p in weights.named_leaves(model)},
                 want_g)


def test_adam_without_clip_is_optax_adam():
    """ClippedAdam(max_norm=None): optax.adam's updates (rtol 1e-6) over
    three steps of random gradients, however large their norm."""
    rng = np.random.RandomState(9)
    shapes = [(4, 3), (7,)]
    params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
    opt = ClippedAdam(params, LR, None)
    tx = optax.adam(LR)
    jp = [jnp.zeros(s) for s in shapes]
    state = tx.init(jp)
    for _ in range(3):
        grads = [(rng.randn(*s) * 100).astype(np.float32) for s in shapes]
        got = opt.updates([torch.as_tensor(g) for g in grads])
        want, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four speech-like utterances of 12 chunks for each split as a
    directory corpus (load_directory), which both trainers read."""
    root = tmp_path_factory.mktemp("corpus")
    for split, seed in (("train", 4), ("val", 5)):
        (root / split).mkdir()
        for u in jds.make_synthetic(4, 12, seed=seed, style="speech",
                                    split=split):
            jf32.write_f32(str(root / split / f"{u.name}.f32"),
                           jf32.flatten_windows(u.windows))
            (u.waveform * 32767).astype(np.int16).tofile(
                str(root / split / f"{u.name}.s16"))
    return str(root)


LINE = re.compile(r"^Epoch: 0 \| time: [\d.]+ \| train_loss: ([\d.]+) "
                  r"\| valid_loss: ([\d.]+) $")


def _overrides(root, save_dir):
    return ["data.synthetic=false", f"data.root={root}", "data.chunks=2",
            "data.batch_size=2", *SMALL, "train.epochs=1",
            "train.steps_per_epoch=2", "train.warmup_batches=0",
            f"train.learning_rate={LR}", f"train.save_dir={save_dir}",
            "train.transfer_model=init", "train.transfer_epoch=0",
            "label=cmp"]


def _record(monkeypatch, module, store):
    log = module.ckpt.log_epoch

    def recording(save_dir, label, epoch, duration, loss, valid, *a, **k):
        store.append((loss, valid))
        return log(save_dir, label, epoch, duration, loss, valid, *a, **k)

    monkeypatch.setattr(module.ckpt, "log_epoch", recording)


def test_trainer_matches_jax(corpus, tmp_path, monkeypatch):
    """One warm step then one mask step (train.warmup_batches=0: scale
    1 -> 6) of both trainers from one JAX checkpoint; the validation
    losses, one warm and one mask batch, too."""
    params = jfp.init_frame_predictor(jax.random.PRNGKey(11), JCFG)
    for d in ("jax", "port"):
        jckpt.save(jckpt.checkpoint_path(str(tmp_path / d), "init", 0),
                   params, optax.adam(LR).init(params), step=0)
    want_l, got_l, grads = [], [], []
    _record(monkeypatch, jtf, want_l)
    _record(monkeypatch, ttf, got_l)
    cfg = JConfig()
    japply(cfg, _overrides(corpus, str(tmp_path / "jax")))
    want, _ = jtf.run(cfg)
    updates = ClippedAdam.updates

    def recording(self, g):
        grads.append([x.clone() for x in g])
        return updates(self, g)

    monkeypatch.setattr(ClippedAdam, "updates", recording)
    cfg = Config()
    apply_overrides(cfg, _overrides(corpus, str(tmp_path / "port")))
    model, _ = ttf.run(cfg, device="cpu")
    assert len(grads) == 2
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    print(f"losses (train sum, valid sum) {got_l} against {want_l}")

    names = [n for n, _ in weights.named_leaves(model)]
    got = dict(weights.flatten(weights.to_params(model)))
    loose = 0
    for name, w in weights.flatten(_tree(want)):
        small = np.zeros(w.shape, bool)
        for g in grads:
            g = g[names.index(name)].numpy()
            small |= np.abs(g) < 1e-3 * np.abs(g).max()
        diff = np.abs(got[name] - w)
        far = diff > 1e-3 * LR + 1e-7
        assert not np.any(far & ~small), (name, float(diff[~small].max()))
        assert float(diff.max()) <= 4 * LR, name
        loose += int(far.sum())
    print(f"{loose} parameters apart by more than 1e-3 lr, each where a "
          "step's gradient was below 1e-3 of its leaf's largest")

    # the port's checkpoint: JAX's restore_params reads it, with the scale
    path = tckpt.checkpoint_path(str(tmp_path / "port"), "cmp", 0)
    payload = jckpt.load(path)
    assert payload["extra"] == {"scale": 6.0} and payload["step"] == 0
    assert payload["opt_state"]["count"] == 2
    restored = jckpt.restore_params(params, payload, "predictor")
    for (n, a), (_, b) in zip(weights.flatten(weights.to_params(model)),
                              weights.flatten(_tree(restored))):
        np.testing.assert_array_equal(a, b, err_msg=n)
    with open(os.path.join(str(tmp_path / "port"), "cmp.txt")) as f:
        assert LINE.match(f.read())


def test_entry_point_refusals(tmp_path):
    """The CLI trains on the card unless --device=cpu; plots name the
    ROADMAP item that will bring them."""
    args = ["data.synthetic=true", "data.synthetic_utterances=2",
            "data.chunks=1", "data.batch_size=2", *SMALL,
            "train.epochs=1", "train.debugging=true",
            f"train.save_dir={tmp_path}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttf.main(args)
    with pytest.raises(ValueError, match="Queue A 8"):
        ttf.main(args + ["train.plot_every=1", "--device=cpu"])
    assert ttf.main(args + ["--device=cpu"]) == 0
