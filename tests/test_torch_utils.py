"""The port's utilities against JAX's and the reference's modules.

fpsc_tpu_torch/utils/{logging,diagnostics,torch_import}.py.  Tolerances:

* logging: MetricsLogger writes JAX's records (apart from `time`);
  profile_trace writes a Chrome trace; anomaly mode raises on a NaN
  backward;
* diagnostics: with train.plot_every=1 both packages' train_frame and
  train_lpcnet (small widths, one step from one JAX checkpoint, lr 1e-6
  so that the weights the plots read stay JAX's within 1e-5) write the
  same files under <save_dir>/<label>/diagnostics/ (when matplotlib is
  present), and the arrays they plot (the heatmaps' inputs, the
  excitation traces, the log-mel image) agree within 1e-5;
* torch_import: on state dicts of torch.nn reference modules built in
  the test (tests/test_torch_import.py's shapes), the port's module
  against the reference module's own forward at rtol 1e-4, atol 1e-5,
  and against JAX's import of the same dict through JAX's forward,
  encoder(qtz=False) and wavenet forward at rtol 1e-5 (atol 1e-6).
"""
import json
import os

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
from fpsc_tpu.dsp.stft import mel_spec as jmel
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import frame_predictor_para as jfpp
from fpsc_tpu.models import lpcnet as jl
from fpsc_tpu.models import wavenet as jwn
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import train_frame as jtf
from fpsc_tpu.train import train_lpcnet as jtl
from fpsc_tpu.utils import diagnostics as jdiag
from fpsc_tpu.utils import logging as jlog
from fpsc_tpu.utils import torch_import as jti

from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.models import frame_predictor as tfp
from fpsc_tpu_torch.models import frame_predictor_para as tfpp
from fpsc_tpu_torch.models import wavenet as twn
from fpsc_tpu_torch.train import train_frame as ttf
from fpsc_tpu_torch.train import train_lpcnet as ttl
from fpsc_tpu_torch.utils import diagnostics as tdiag
from fpsc_tpu_torch.utils import logging as tlog
from fpsc_tpu_torch.utils import torch_import as tti
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


RNG = np.random.RandomState(81)


# ---------------------------------------------------------------- logging

def test_metrics_logger_writes_jax_records(tmp_path):
    rows = {}
    for name, mod in (("jax", jlog), ("port", tlog)):
        p = str(tmp_path / name / "m.jsonl")
        log = mod.MetricsLogger(p)
        log.log(0, loss=1.5)
        log.log(1, loss=1.2, lr=1e-4)
        mod.MetricsLogger(str(tmp_path / name / "off.jsonl"),
                          enabled=False).log(0, loss=1.0)
        rows[name] = [json.loads(line) for line in open(p)]
        assert not os.path.exists(tmp_path / name / "off.jsonl")
    for got, want in zip(rows["port"], rows["jax"]):
        assert list(got) == list(want)
        assert {k: v for k, v in got.items() if k != "time"} == {
            k: v for k, v in want.items() if k != "time"}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tlog.profile_trace(None) as prof:
        assert prof is None
    d = str(tmp_path / "trace")
    a = torch.randn(64, 64)
    with tlog.profile_trace(d) as prof:
        (a @ a).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    (trace,) = os.listdir(d)
    with open(os.path.join(d, trace)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_nan_debugging_raises_on_a_nan_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    tlog.enable_nan_debugging(True)
    try:
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        tlog.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()            # off: no raise
    assert torch.isnan(x.grad).all()


# ------------------------------------------------------------ diagnostics

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speech-like utterances of 12 chunks as a directory corpus for each
    split, which both packages' trainers read."""
    root = tmp_path_factory.mktemp("corpus")
    for split, seed, n in (("train", 4, 3), ("val", 5, 2)):
        (root / split).mkdir()
        for u in jds.make_synthetic(n, 12, seed=seed, style="speech",
                                    split=split):
            jf32.write_f32(str(root / split / f"{u.name}.f32"),
                           jf32.flatten_windows(u.windows))
            (u.waveform * 32767).astype(np.int16).tofile(
                str(root / split / f"{u.name}.s16"))
    return str(root)


def _recorded(monkeypatch, mod, store):
    """Keep the arrays each save_* function of a diagnostics module is
    given, and let it draw them."""
    for fn in ("save_feature_heatmap", "save_excitation_plot",
               "save_spectrogram"):
        real = getattr(mod, fn)

        def rec(save_dir, label, epoch, *arrays, _real=real, _fn=fn, **kw):
            store.append((_fn, epoch, [None if a is None else np.asarray(a)
                                       for a in arrays]))
            return _real(save_dir, label, epoch, *arrays, **kw)

        monkeypatch.setattr(mod, fn, rec)


def _files(save_dir, label):
    d = os.path.join(save_dir, label, "diagnostics")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _same_plots(got, want):
    assert [(f, e) for f, e, _ in got] == [(f, e) for f, e, _ in want]
    for (fn, _, g_arrays), (_, _, w_arrays) in zip(got, want):
        assert len(g_arrays) == len(w_arrays)
        for g, w in zip(g_arrays, w_arrays):
            assert (g is None) == (w is None), fn
            if g is not None:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                           err_msg=fn)
        if fn == "save_spectrogram":
            # the image itself: the port's log-mel against JAX's
            want_img = 10.0 * np.log10(np.maximum(np.asarray(jmel(
                jnp.asarray(w_arrays[0].astype(np.float32)))), 1e-10))
            np.testing.assert_allclose(tdiag.log_mel(g_arrays[0]), want_img,
                                       rtol=1e-5, atol=1e-5)


PLOT_LR = 1e-6


def test_train_frame_plots_match_jax(corpus, tmp_path, monkeypatch):
    cfg_j = jfp.FramePredictorConfig(gru_units1=32, gru_units2=16)
    params = jfp.init_frame_predictor(jax.random.PRNGKey(11), cfg_j)
    for d in ("jax", "port"):
        jckpt.save(jckpt.checkpoint_path(str(tmp_path / d), "init", 0),
                   params, optax.adam(PLOT_LR).init(params), step=0)
    args = ["data.synthetic=false", f"data.root={corpus}", "data.chunks=2",
            "data.batch_size=2", "predictor.gru_units1=32",
            "predictor.gru_units2=16", "train.epochs=1",
            "train.debugging=true", f"train.learning_rate={PLOT_LR}",
            "train.transfer_model=init", "train.transfer_epoch=0",
            "train.plot_every=1", "label=plots"]
    want, got = [], []
    _recorded(monkeypatch, jdiag, want)
    _recorded(monkeypatch, tdiag, got)
    cfg = JConfig()
    japply(cfg, args + [f"train.save_dir={tmp_path / 'jax'}"])
    jtf.run(cfg)
    cfg = Config()
    apply_overrides(cfg, args + [f"train.save_dir={tmp_path / 'port'}"])
    ttf.run(cfg, device="cpu")
    assert [f for f, _, _ in got] == ["save_feature_heatmap"]
    _same_plots(got, want)
    assert (_files(str(tmp_path / "port"), "plots")
            == _files(str(tmp_path / "jax"), "plots"))
    if tdiag.have_matplotlib():
        assert _files(str(tmp_path / "port"), "plots") == [
            "feat_0.png", "feat_out_0.png"]


@pytest.mark.parametrize("bunch", [1, 2])
def test_train_lpcnet_plots_match_jax(corpus, tmp_path, monkeypatch, bunch):
    """The teacher excitation, the argmax draw (bunch 1 only, as in JAX)
    and the signal's log-mel of the last batch's first item."""
    jcfg = jl.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                           cond_units=16)
    if bunch == 1:
        params = jl.init_lpcnet(jax.random.PRNGKey(7), jcfg)
    else:
        from fpsc_tpu.models import lpcnet_bunched as jb
        params = jb.init_bunched(jax.random.PRNGKey(7), jcfg)
    args = ["data.synthetic=false", f"data.root={corpus}", "data.chunks=1",
            "data.batch_size=2", "lpcnet.gru_a_units=32",
            "lpcnet.gru_b_units=8", "lpcnet.embed_dim=16",
            "lpcnet.cond_units=16", f"lpcnet.bunch={bunch}",
            "train.epochs=1", "train.steps_per_epoch=1",
            f"train.learning_rate={PLOT_LR}", "train.save_every=1000",
            "train.plot_every=1", "label=plots"]
    want, got = [], []
    _recorded(monkeypatch, jdiag, want)
    _recorded(monkeypatch, tdiag, got)
    cfg = JConfig()
    japply(cfg, args + [f"train.save_dir={tmp_path / 'jax'}"])
    jtl.run(cfg, init_params=params)
    cfg = Config()
    apply_overrides(cfg, args + [f"train.save_dir={tmp_path / 'port'}"])
    ttl.run(cfg, init_params=jax.tree_util.tree_map(np.asarray, params),
            device="cpu")
    assert [f for f, _, _ in got] == ["save_excitation_plot",
                                      "save_spectrogram"]
    assert (got[0][2][1] is None) == (bunch != 1)
    _same_plots(got, want)
    assert (_files(str(tmp_path / "port"), "plots_s")
            == _files(str(tmp_path / "jax"), "plots_s"))


def test_plots_are_off_without_plot_every():
    assert not tdiag.should_plot(0, 0)
    assert tdiag.should_plot(2, 4) == tdiag.have_matplotlib()
    assert not tdiag.should_plot(2, 3)


# ----------------------------------------------------------- torch_import

class Wavernn(torch.nn.Module):
    """The reference's predictor layout (src/models/wavernn.py:22-60);
    with mask=True also its (commented-out) bidirectional mask GRU."""

    def __init__(self, g1=24, g2=12, mask=False):
        super().__init__()
        self.rnn1 = torch.nn.GRU(20, g1, 1, batch_first=True)
        self.rnn2 = torch.nn.GRU(g1, g2, 1, batch_first=True)
        self.dual_fc = torch.nn.Sequential(torch.nn.Linear(g2, 18),
                                           torch.nn.Tanh())
        if mask:
            self.mask_rnn = torch.nn.GRU(20, 6, 1, batch_first=True,
                                         bidirectional=True)
            self.mask_fc = torch.nn.Sequential(torch.nn.Linear(12, 2))

    def forward(self, x):
        h1, _ = self.rnn1(x)
        h2, _ = self.rnn2(h1)
        # the shared FC on two copies of the ReLU'd output, summed
        return 2.0 * self.dual_fc(torch.relu(h2))


class WavernnPara(torch.nn.Module):
    """The reference's Wavernn_para layout (wavernn_para.py:21-69)."""

    def __init__(self):
        super().__init__()
        self.rnn1 = torch.nn.GRU(20, 24, 1, batch_first=True)
        self.rnn2 = torch.nn.GRU(24, 12, 1, batch_first=True)
        self.rnn3 = torch.nn.GRU(18, 18, 1, batch_first=True)
        self.dual_fc = torch.nn.Sequential(torch.nn.Linear(12, 18),
                                           torch.nn.Tanh())

    def forward(self, x):
        h1, _ = self.rnn1(x)
        h2, _ = self.rnn2(h1)
        x_mid = 2.0 * self.dual_fc(torch.relu(h2))
        h3, _ = self.rnn3(torch.flip(x_mid, [1]))
        return x_mid, torch.tanh(h3)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("mask", [False, True])
def test_wavernn_import(mask):
    torch.manual_seed(3)
    ref = Wavernn(mask=mask)
    sd = ref.state_dict()
    x = (RNG.randn(2, 9, 20) * 0.3).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.as_tensor(x))
    model, cfg = tti.wavernn_to_frame_predictor(sd, device="cpu")
    assert (cfg.gru_units1, cfg.gru_units2, cfg.fc_units) == (24, 12, 18)
    with torch.no_grad():
        got = tfp.forward(model, torch.as_tensor(x))[0]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)

    jparams, jcfg = jti.wavernn_to_frame_predictor(sd)
    assert cfg.gru_units1 == jcfg.gru_units1
    jout = jfp.forward(jparams, jnp.asarray(x))[0]
    np.testing.assert_allclose(_np(got), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    with torch.no_grad():
        enc = tfp.encoder(model, torch.as_tensor(x), l1=0.09, l2=0.28,
                          qtz=False)
    jenc = jfp.encoder(jparams, jnp.asarray(x), l1=0.09, l2=0.28, qtz=False)
    for k in ("c_in", "r"):
        np.testing.assert_allclose(_np(enc[k]), np.asarray(jenc[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if mask:
        assert cfg.mask_units == 6
        with torch.no_grad():
            m = tfp.mask_forward(model, torch.as_tensor(x), 3.0)
        jm = jfp.mask_forward(jparams, jnp.asarray(x), jnp.float32(3.0))
        np.testing.assert_allclose(_np(m), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6)
    else:
        # fresh mask layers, drawn from a seeded generator
        again, _ = tti.wavernn_to_frame_predictor(sd, device="cpu")
        for (n, a), (_, b) in zip(model.named_parameters(),
                                  again.named_parameters()):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=n)


def test_wavernn_para_import():
    torch.manual_seed(4)
    ref = WavernnPara()
    sd = ref.state_dict()
    x = (RNG.randn(2, 7, 20) * 0.3).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.as_tensor(x))
    model, cfg = tti.wavernn_para_to_params(sd, device="cpu")
    assert (cfg.gru_units1, cfg.gru_units2, cfg.fc_units) == (24, 12, 18)
    with torch.no_grad():
        got = tfpp.forward(model, torch.as_tensor(x))[:2]
    jparams, _ = jti.wavernn_para_to_params(sd)
    jout = jfpp.forward(jparams, jnp.asarray(x))[:2]
    for g, w, j in zip(got, want, jout):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def _wavenet_state_dict(params):
    """A torch-layout Wavenet state dict of JAX parameters (the layout
    of tests/test_torch_import.py::test_wavenet_import_roundtrip): weight
    norm on every convolution but c_conv, the transposed convolutions at
    every second index of upsample_conv, a 256-row embedding."""
    def tt(a):
        return torch.tensor(np.asarray(a))

    sd = {}

    def put_wn(prefix, p):
        sd[f"{prefix}.weight_v"] = tt(p.v)
        sd[f"{prefix}.weight_g"] = tt(p.g).reshape(-1, 1, 1)
        sd[f"{prefix}.bias"] = tt(p.b)

    put_wn("front_conv.0.conv", params.front)
    for i, blk in enumerate(params.blocks):
        for name, p in (("filter_conv.conv", blk.filter_conv),
                        ("gate_conv.conv", blk.gate_conv),
                        ("res_conv", blk.res_conv),
                        ("skip_conv", blk.skip_conv),
                        ("filter_conv_c", blk.filter_cond),
                        ("gate_conv_c", blk.gate_cond)):
            put_wn(f"res_blocks.{i}.{name}", p)
    put_wn("final_conv.1.conv", params.final1)
    put_wn("final_conv.3.conv", params.final2)
    up = params.upsampler
    sd["embedding.weight"] = tt(up.period_emb.table[:256])
    sd["c_conv.0.weight"] = tt(jwn.wn_weight(up.c_conv1))
    sd["c_conv.0.bias"] = tt(up.c_conv1.b)
    sd["c_conv.2.weight"] = tt(jwn.wn_weight(up.c_conv2))
    sd["c_conv.2.bias"] = tt(up.c_conv2.b)
    for k in ("0", "2"):
        fc = up.c_fc1 if k == "0" else up.c_fc2
        sd[f"c_fc.{k}.weight"] = tt(fc.w)
        sd[f"c_fc.{k}.bias"] = tt(fc.b)
    for i, (k, g, b) in enumerate(zip(up.convt, up.convt_g, up.convt_b)):
        sd[f"upsample_conv.{2 * i}.weight_v"] = tt(k)
        sd[f"upsample_conv.{2 * i}.weight_g"] = tt(g).reshape(1, 1, 1, 1)
        sd[f"upsample_conv.{2 * i}.bias"] = tt(b).reshape(1)
    return sd


def test_wavenet_import(tmp_path):
    kw = dict(num_blocks=1, num_layers=2, residual_channels=8,
              gate_channels=12, skip_channels=8, cout_channels=12,
              front_kernel=4, cin_channels=20)
    jcfg, tcfg = jwn.WavenetConfig(**kw), twn.WavenetConfig(**kw)
    params = jwn.init_wavenet(jax.random.PRNGKey(0), jcfg)
    sd = _wavenet_state_dict(params)
    path = str(tmp_path / "wn.pth")
    torch.save(sd, path)
    loaded = tti.load_state_dict(path)
    assert list(loaded) == list(sd)
    model = tti.wavenet_to_params(loaded, tcfg, device="cpu")
    assert model.upsampler.period_emb.table.shape[0] == 512
    x = (RNG.randn(1, 1, 320) * 0.1).astype(np.float32)
    c = (RNG.randn(1, 20, 2) * 0.3).astype(np.float32)
    periods = RNG.randint(32, 250, (1, 2)).astype(np.int32)
    with torch.no_grad():
        got = _np(twn.forward(model, tcfg, torch.as_tensor(x),
                              torch.as_tensor(periods, dtype=torch.long),
                              torch.as_tensor(c)))
    args = (jnp.asarray(x), jnp.asarray(periods), jnp.asarray(c))
    forward = jax.jit(jwn.forward, static_argnums=1)
    want = np.asarray(forward(params, jcfg, *args))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jimported = jti.wavenet_to_params(sd)
    np.testing.assert_allclose(
        got, np.asarray(forward(jimported, jcfg, *args)), rtol=1e-5,
        atol=1e-6)


def test_import_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tti.wavernn_para_to_params(WavernnPara().state_dict())


def test_every_jax_module_has_a_twin():
    """Every fpsc_tpu/**/*.py has a twin at the same relative path in
    fpsc_tpu_torch/."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def modules(pkg):
        root = os.path.join(repo, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}

    assert not sorted(modules("fpsc_tpu") - modules("fpsc_tpu_torch"))
