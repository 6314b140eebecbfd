"""The port's vocoder trainer against JAX's, and its checkpoints.

fpsc_tpu_torch/train/train_lpcnet.py::run(device="cpu") against
fpsc_tpu/train/train_lpcnet.py::run from the same initial parameters on
the same corpus (a directory of .f32 dumps and .s16 audio that both
packages' loaders read), two steps at the small widths of
tests/test_lpcnet.py (GRU_A 32, GRU_B 8, E 16, cond 16, B=2,
data.chunks=1).  Tolerances:

* each step's loss (the results file's lines, and the value each
  trainer logs) rtol 1e-4;
* the final parameters: within 1e-3 lr (+1e-7) of JAX's, except where a
  step's gradient was below 1e-3 of its leaf's largest element: there
  Adam's first steps are almost sign functions (g / (|g| + 1e-8)), so
  two right implementations may part by up to 2 lr a step; those
  elements are counted and printed;
* GRU_A's sparsity pattern after the ramp: the same;
* the mu-law indices of the trained streams: counted where they differ
  (at most one in a thousand), and printed.

Beside it: the noise ramp, checkpoints that the port's loader, JAX's
restore_params and the port's decode CLI read back, warm starts from a
JAX checkpoint, coded_dataset, and the entry point's refusals.
"""
import os
import pickle
import re

import numpy as np
import pytest
import torch

import jax

from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.data import dataset as jds
from fpsc_tpu.data import f32 as jf32
from fpsc_tpu.dsp.mulaw import l2u_index as jl2u
from fpsc_tpu.models import lpcnet as jl
from fpsc_tpu.models import lpcnet_bunched as jb
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import train_lpcnet as jt

from fpsc_tpu_torch.codec import cli as tcli
from fpsc_tpu_torch.config.config import Config
from fpsc_tpu_torch.config.config import apply_overrides
from fpsc_tpu_torch.data import dataset as tds
from fpsc_tpu_torch.dsp.mulaw import l2u_index
from fpsc_tpu_torch.models import lpcnet as tl
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.train import train_lpcnet as tt
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


SMALL = ["lpcnet.gru_a_units=32", "lpcnet.gru_b_units=8",
         "lpcnet.embed_dim=16", "lpcnet.cond_units=16"]
JCFG = jl.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                       cond_units=16)
LR = 1e-3
STEPS = 2
LINE = re.compile(r"^Epoch: (\d+) \| time: [\d.]+ \| train_loss: ([\d.]+) "
                  r"\| valid_loss: 0\.0000 $")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three speech-like utterances of 12 chunks as a directory corpus
    (load_directory), so that both trainers read the same features."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "train").mkdir()
    for u in jds.make_synthetic(3, 12, seed=4, style="speech"):
        jf32.write_f32(str(root / "train" / f"{u.name}.f32"),
                       jf32.flatten_windows(u.windows))
        (u.waveform * 32767).astype(np.int16).tofile(
            str(root / "train" / f"{u.name}.s16"))
    return str(root)


def _overrides(root, save_dir, extra=()):
    return ["data.synthetic=false", f"data.root={root}", "data.chunks=1",
            "data.batch_size=2", *SMALL, f"train.epochs={STEPS}",
            "train.steps_per_epoch=1", f"train.learning_rate={LR}",
            f"train.save_dir={save_dir}", "train.save_every=1000",
            "label=cmp", *extra]


def _jax_cfg(overrides):
    cfg = JConfig()
    japply(cfg, overrides)
    return cfg


def _port_cfg(overrides):
    cfg = Config()
    apply_overrides(cfg, overrides)
    return cfg


def _results(save_dir):
    with open(os.path.join(save_dir, "cmp_s.txt")) as f:
        lines = f.readlines()
    got = [LINE.match(line) for line in lines]
    assert all(got), lines
    assert [int(m.group(1)) for m in got] == list(range(STEPS))
    return [float(m.group(2)) for m in got]


def _record(monkeypatch, module, store):
    """Keep the full-precision loss each trainer hands its log_epoch."""
    log = module.ckpt.log_epoch

    def recording(save_dir, label, epoch, duration, loss, *a, **k):
        store.append(loss)
        return log(save_dir, label, epoch, duration, loss, *a, **k)

    monkeypatch.setattr(module.ckpt, "log_epoch", recording)


RUNS = {
    "bunch1": (1, []),
    "bunch2_sparse": (2, ["lpcnet.bunch=2", "lpcnet.gru_a_density=0.5",
                          "lpcnet.sparsify_start=0", "lpcnet.sparsify_end=1",
                          "lpcnet.sparsify_block=16,16"]),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax(corpus, tmp_path, monkeypatch, run):
    bunch, extra = RUNS[run]
    init = {1: jl.init_lpcnet, 2: jb.init_bunched}[bunch]
    params = init(jax.random.PRNGKey(7), JCFG)
    tree = jax.tree_util.tree_map(np.asarray, params)
    want_losses, got_losses, grads = [], [], []
    _record(monkeypatch, jt, want_losses)
    _record(monkeypatch, tt, got_losses)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want, want_min = jt.run(_jax_cfg(_overrides(corpus, jdir, extra)),
                            init_params=params)
    updates = tt.ClippedAdam.updates

    def recording(self, g):
        grads.append([x.clone() for x in g])
        return updates(self, g)

    monkeypatch.setattr(tt.ClippedAdam, "updates", recording)
    model, got_min = tt.run(_port_cfg(_overrides(corpus, tdir, extra)),
                            init_params=tree, device="cpu")
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    np.testing.assert_allclose(_results(tdir), _results(jdir), rtol=0,
                               atol=1.5e-4)
    np.testing.assert_allclose(got_min, want_min, rtol=1e-4)
    print(f"{run}: losses {got_losses} against {want_losses}")
    # the mu-law indices of the streams each trainer built
    ds = jds.load_directory(corpus, "train")
    flips = 0
    for epoch in range(STEPS):
        batch = next(jds.Dataset(ds, 1).iter_batches(2, seed=epoch))
        arrs = jt.vocoder_inputs(batch)
        want_s = jl.teacher_streams(arrs["x"], arrs["lpc"])
        got_s = tl.teacher_streams(torch.as_tensor(arrs["x"]),
                                   torch.as_tensor(arrs["lpc"]))
        flips += sum(int((l2u_index(g * 32768.0).numpy() != np.asarray(
            jl2u(w * 32768.0))).sum()) for g, w in zip(got_s, want_s))
    print(f"{run}: {flips} mu-law index flips in the trained streams")
    assert flips <= STEPS * 2 * 2400 // 1000

    names = [n for n, _ in weights.named_leaves(model)]
    got = dict(weights.flatten(weights.to_params(model)))
    loose = 0
    for i, (name, w) in enumerate(weights.flatten(
            jax.tree_util.tree_map(np.asarray, want))):
        step_g = [weights._jax_layout(name, g[names.index(name)]).numpy()
                  for g in grads]
        small = np.zeros(w.shape, bool)
        for g in step_g:
            small |= np.abs(g) < 1e-3 * np.abs(g).max()
        diff = np.abs(got[name] - w)
        far = diff > 1e-3 * LR + 1e-7
        assert not np.any(far & ~small), (name, float(diff[~small].max()))
        assert float(diff.max()) <= 2 * STEPS * LR, name
        loose += int(far.sum())
        if name == "base.gru_a.wh":
            np.testing.assert_array_equal(got[name] == 0, w == 0)
            assert 0.3 < float(np.mean(w == 0)) < 0.7
    print(f"{run}: {loose} parameters apart by more than 1e-3 lr, each "
          "where a step's gradient was below 1e-3 of its leaf's largest")


def test_noise_ramp_sparsity_and_checkpoints(tmp_path, monkeypatch):
    """bunch=2 on the synthetic speech fixture (analysed on the CPU):
    two clean epochs, then noise (noise_warmup_frac=0.5 of 4 epochs),
    GRU_A ramped to 0.75 in (16, 16) blocks (9 of 12 live, the
    6 diagonal ones among them), a checkpoint an epoch.
    The last checkpoint holds the returned weights: the port's loader,
    JAX's restore_params and the port's decode CLI read them back."""
    noisy = []
    streams = tl.noisy_streams
    monkeypatch.setattr(tl, "noisy_streams",
                        lambda *a, **k: noisy.append(1) or streams(*a, **k))
    save = str(tmp_path)
    cfg = _port_cfg([
        "data.synthetic=true", "data.synthetic_style=speech",
        "data.synthetic_utterances=2", "data.chunks=1", "data.batch_size=2",
        *SMALL, "lpcnet.bunch=2", "lpcnet.noise_levels=2",
        "lpcnet.noise_warmup_frac=0.5", "lpcnet.gru_a_density=0.75",
        "lpcnet.sparsify_start=0", "lpcnet.sparsify_end=3",
        "lpcnet.sparsify_block=16,16", "train.epochs=4",
        "train.steps_per_epoch=1", f"train.save_dir={save}", "label=ramp"])
    model, loss = tt.run(cfg, device="cpu")
    assert np.isfinite(loss)
    assert len(noisy) == 2
    wh = model.base.gru_a.wh.detach().numpy()
    live = np.abs(wh.reshape(6, 16, 2, 16)).sum((1, 3)) > 0
    assert live.sum() == 9
    assert sorted(os.listdir(tmp_path / "ramp_s")) == [
        f"ramp_s_{e}.ckpt" for e in range(4)]
    path = tckpt.checkpoint_path(save, "ramp_s", 3)
    payload = tckpt.load(path)
    assert type(payload["params"]).__name__ == "BunchedParams"
    assert payload["step"] == 3 and payload["opt_state"]["count"] == 4
    want = weights.flatten(weights.to_params(model))
    for (n, a), (_, b) in zip(want, weights.flatten(payload["params"])):
        np.testing.assert_array_equal(a, b, err_msg=n)
    template = jb.init_bunched(jax.random.PRNGKey(0), JCFG)
    restored = jckpt.restore_params(template, jckpt.load(path))
    for (n, a), (_, b) in zip(want, weights.flatten(
            jax.tree_util.tree_map(np.asarray, restored))):
        np.testing.assert_array_equal(a, b, err_msg=n)
    cfg.train.vocoder_model, cfg.train.vocoder_epoch = "ramp_s", 3
    vocoder = tcli.load_vocoder(cfg, torch.device("cpu"))
    for (n, a), (_, b) in zip(want, weights.flatten(
            weights.to_params(vocoder))):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_warm_start_from_a_jax_checkpoint(corpus, tmp_path, monkeypatch):
    """train.transfer_model names a checkpoint JAX's trainer format
    wrote (params and optax state): the port's first step from it is
    JAX's first step from the same params."""
    params = jb.init_bunched4(jax.random.PRNGKey(2), JCFG)
    import optax
    jckpt.save(tckpt.checkpoint_path(str(tmp_path), "warm", 0), params,
               optax.adam(1e-3).init(params), step=0)
    want, got = [], []
    _record(monkeypatch, jt, want)
    _record(monkeypatch, tt, got)
    extra = ["lpcnet.bunch=4", "train.epochs=1"]
    jt.run(_jax_cfg(_overrides(corpus, str(tmp_path / "j"), extra)),
           init_params=params)
    tt.run(_port_cfg(_overrides(corpus, str(tmp_path), extra + [
        "train.transfer_model=warm", "train.transfer_epoch=0"])),
        device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_coded_dataset_matches_jax(tmp_path):
    """coded_dataset pairs the coded windows of the utterances that have
    them with their waveforms' heads: the same items and batches."""
    items = jds.make_synthetic(3, 12, seed=2)
    rng = np.random.RandomState(0)
    (tmp_path / "train").mkdir()
    for u, k in ((items[0], 5), (items[2], 7)):
        np.save(str(tmp_path / "train" / f"{u.name}.npy"),
                rng.randn(k, 19, 36).astype(np.float64))
    want = jt.coded_dataset(str(tmp_path), jds.Dataset(items, 2, "train"))
    got = tt.coded_dataset(str(tmp_path), tds.Dataset(
        [tds.Utterance(u.name, u.waveform, u.windows) for u in items], 2,
        "train"))
    assert [u.name for u in got.items] == [u.name for u in want.items]
    for g, w in zip(got.items, want.items):
        assert g.windows.dtype == np.float32
        np.testing.assert_array_equal(g.windows, w.windows)
        np.testing.assert_array_equal(g.waveform, w.waveform)
    g, w = (next(d.iter_batches(2, seed=3, head=True)) for d in (got, want))
    for k in ("x", "feat", "nm_feat"):
        np.testing.assert_array_equal(g[k], w[k])
    arrs, jarrs = tt.vocoder_inputs(g), jt.vocoder_inputs(w)
    for k in jarrs:
        np.testing.assert_array_equal(arrs[k], jarrs[k], err_msg=k)


def test_entry_point_refusals(tmp_path):
    """The CLI trains on the card unless --device=cpu; plots and
    process sharding name the ROADMAP item that will bring them."""
    args = ["data.synthetic=true", "data.synthetic_utterances=2",
            "data.chunks=1", "data.batch_size=2", *SMALL,
            "train.epochs=1", "train.debugging=true",
            f"train.save_dir={tmp_path}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.main(args)
    assert tt.main(args + ["--device=cpu"]) == 0
    with pytest.raises(ValueError, match="ROADMAP Queue A 8"):
        tt.main(args + ["train.plot_every=1", "--device=cpu"])
    with pytest.raises(ValueError, match="ROADMAP Queue A 8"):
        tt.main(args + ["data.shard_by_process=true", "--device=cpu"])
    with pytest.raises(ValueError, match="lpcnet.bunch=3"):
        tt.main(args + ["lpcnet.bunch=3", "--device=cpu"])


class Foreign:
    pass


@pytest.mark.parametrize("payload", [
    {"params": Foreign()}, tckpt.save, tckpt._Unpickler])
def test_checkpoint_loader_refuses_what_is_not_a_parameter_class(
        tmp_path, payload):
    """The port's own classes load; a class of the test, a function and
    another class of the checkpoint module itself are refused."""
    path = tmp_path / "x.ckpt"
    path.write_bytes(pickle.dumps(payload))
    with pytest.raises(ValueError, match="does not accept"):
        tckpt.load(str(path))
    tree = tckpt.GRUParams(*(np.ones(2, np.float32) for _ in range(4)))
    path.write_bytes(pickle.dumps({"params": tree}))
    back = tckpt.load(str(path))["params"]
    assert type(back) is tckpt.GRUParams
    assert all(np.array_equal(a, b) for a, b in zip(back, tree))
