"""The port's codec pipeline entries against JAX's.

train_cb, generate_qtz_features, frame_evaluation and synthesis_qtz of
fpsc_tpu_torch/train/ (with codec.coded_feature_windows, the range
coder's prior collection and static-model coder, and rate control's
decimation and operating-point search) against fpsc_tpu's on the CPU,
on one directory corpus that both loaders read, from one JAX predictor
checkpoint (GRU 32 / 16, its head scaled by 0.05 so that the coded
cepstra stay in the range of speech) at the small codebook geometry of
tests/test_entries.py (scalar 8 / 4, VQ (8, 8), VQ_bl (8,)), the
thresholds raised (l1 0.3, l2 2.5) so that both streams are live.
Tolerances:

* train_cb with JAX's LBG perturbations injected: the VQ books at rtol
  1e-5, the scalar books at rtol 1e-6 (test_torch_lbg.py says why);
* collect_priors, entropy_pack / entropy_unpack, the decimation helpers,
  pareto_frontier and select_*: exact;
* coded_feature_windows: the coded rows exact, the LPC at atol 1e-3
  (ROADMAP Queue C 4);
* generate_qtz_features: the same windows (LPC atol 1e-3), streams,
  priors, entropies and bitrates; the MSE at rtol 1e-5;
* frame_evaluation: within 1e-3;
* synthesis_qtz: the same bytes, the coded windows as above, the audio
  with JAX's uniforms injected held by lpcnet_sampler.trajectory_flips;
* measure_operating_points / measure_rd_surface: the same b/s, the MSE
  at rtol 1e-5.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fpsc_tpu.codec import codec as jcodec
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.codec import rate_control as jrate
from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.data import dataset as jds
from fpsc_tpu.data import f32 as jf32
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import lpcnet as jlpcnet
from fpsc_tpu.train import checkpoint as jckpt
from fpsc_tpu.train import frame_evaluation as jfe
from fpsc_tpu.train import generate_qtz_features as jgq
from fpsc_tpu.train import synthesis_qtz as jsq
from fpsc_tpu.train import train_cb as jtc

from fpsc_tpu_torch.codec import codec as tcodec
from fpsc_tpu_torch.codec import native_rc as tnative
from fpsc_tpu_torch.codec import range_coder as trc
from fpsc_tpu_torch.codec import rate_control as trate
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.ops.lpcnet_sampler import trajectory_flips
from fpsc_tpu_torch.quant import lbg as tl
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.train import frame_evaluation as tfe
from fpsc_tpu_torch.train import generate_qtz_features as tgq
from fpsc_tpu_torch.train import synthesis_qtz as tsq
from fpsc_tpu_torch.train import train_cb as ttc
from fpsc_tpu_torch.train import train_lpcnet as ttl
from fpsc_tpu_torch.train import weights
from fpsc_tpu_torch.utils.device import torch_threads

from test_torch_lbg import jax_perturbations


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


SMALL = ["predictor.gru_units1=32", "predictor.gru_units2=16",
         "lpcnet.gru_a_units=32", "lpcnet.gru_b_units=8",
         "lpcnet.embed_dim=16", "lpcnet.cond_units=16",
         "codec.vq_entries=8,8", "codec.vq_entries_bl=8",
         "codec.scl_entries=8", "codec.scl_entries_bl=4",
         "codec.l1=0.3", "codec.l2=2.5"]
JVOC = jlpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                            cond_units=16)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The corpus (4 speech-like utterances of 12 chunks a split) and the
    JAX predictor checkpoint `pred` under runs/."""
    root = tmp_path_factory.mktemp("pipeline")
    for split, seed in (("train", 4), ("val", 5)):
        (root / "corpus" / split).mkdir(parents=True)
        for u in jds.make_synthetic(4, 12, seed=seed, style="speech",
                                    split=split):
            base = str(root / "corpus" / split / u.name)
            jf32.write_f32(base + ".f32", jf32.flatten_windows(u.windows))
            (u.waveform * 32767).astype(np.int16).tofile(base + ".s16")
    pred = jfp.init_frame_predictor(
        jax.random.PRNGKey(11), jfp.FramePredictorConfig(gru_units1=32,
                                                         gru_units2=16))
    pred = pred._replace(fc=pred.fc._replace(w=pred.fc.w * 0.05,
                                             b=pred.fc.b * 0.05))
    jckpt.save(jckpt.checkpoint_path(str(root / "runs"), "pred", 0), pred)
    return root


def _overrides(work, cb_path, extra=()):
    return ["data.synthetic=false", f"data.root={work / 'corpus'}",
            "data.chunks=2", "data.batch_size=2", *SMALL,
            f"train.save_dir={work / 'runs'}", "train.transfer_model=pred",
            "train.transfer_epoch=0", f"codec.codebook_path={cb_path}",
            *extra]


def _cfgs(work, cb_path, extra=()):
    ov = _overrides(work, cb_path, extra)
    j, t = JConfig(), Config()
    japply(j, ov)
    apply_overrides(t, ov)
    return j, t


@pytest.fixture(scope="module")
def books(work):
    """train_cb of both packages on two batches (batch 0 trains, batch 1
    refines), the port given JAX's LBG draws -> (JAX's .npz, the port's)."""
    paths = str(work / "jax_cb.npz"), str(work / "port_cb.npz")
    extra = ["train.steps_per_epoch=2"]
    jcfg, _ = _cfgs(work, paths[0], extra)
    want = jtc.run(jcfg)
    _, tcfg = _cfgs(work, paths[1], extra)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "perturbations", jax_perturbations)
        got = ttc.run(tcfg, device="cpu")
    return paths, want, got


def test_train_cb_matches_jax(books):
    (jpath, tpath), want, got = books
    for w, g in zip(want.vq + want.vq_bl, got.vq + got.vq_bl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    for w, g in ((want.scl, got.scl), (want.scl_bl, got.scl_bl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-9)
    # each package's file loads in the other
    j = jckpt.load_codebooks(tpath)
    assert [np.shape(b) for b in j.vq + j.vq_bl] == [(8, 17)] * 3
    t = tckpt.load_codebooks(jpath, "cpu")
    assert t.scl.shape == (8,) and t.scl_bl.shape == (4,)


def _copy_books(work, books, name):
    """A fresh copy of JAX's books: generate_qtz_features writes its
    priors into the file it reads."""
    path = str(work / f"{name}.npz")
    shutil.copy(books[0][0], path)
    return path


@pytest.fixture(scope="module")
def generated(work, books):
    runs = {}
    for pkg in ("jax", "port"):
        path = _copy_books(work, books, f"gen_{pkg}")
        jcfg, tcfg = _cfgs(work, path)
        out = str(work / f"qtz_{pkg}")
        runs[pkg] = (jgq.run(jcfg, out_dir=out) if pkg == "jax" else
                     tgq.run(tcfg, out_dir=out, device="cpu")), path
    return runs


def test_generate_qtz_features_matches_jax(generated):
    (want, jpath), (got, tpath) = generated["jax"], generated["port"]
    for k in ("entropies", "bitrate", "bitrate_rc", "bitrate_priors"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5)
    assert sorted(got["priors"]) == sorted(want["priors"])
    for k, v in want["priors"].items():
        np.testing.assert_array_equal(got["priors"][k], v, err_msg=k)
    for k, v in want["orders"].items():
        np.testing.assert_array_equal(got["orders"][k], v)
    ws = np.load(os.path.join(want["out_dir"], "streams.npz"))
    gs = np.load(os.path.join(got["out_dir"], "streams.npz"))
    assert sorted(gs.files) == sorted(ws.files)
    assert int(ws["n_utterances"]) == 4
    for k in ws.files:
        assert gs[k].dtype == ws[k].dtype, k
        np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)
    names = sorted(os.listdir(os.path.join(want["out_dir"], "train")))
    assert sorted(os.listdir(os.path.join(got["out_dir"], "train"))) == names
    for n in names:
        w = np.load(os.path.join(want["out_dir"], "train", n))
        g = np.load(os.path.join(got["out_dir"], "train", n))
        assert g.shape == w.shape == (2, 19, 36)
        np.testing.assert_allclose(g[..., :20], w[..., :20], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g[..., 20:], w[..., 20:], atol=1e-3)
    # the priors each wrote beside the books load in both packages
    for path in (jpath, tpath):
        for pri in (jckpt.load_priors(path), tckpt.load_priors(path)):
            for k, v in want["priors"].items():
                np.testing.assert_array_equal(pri[k], v, err_msg=k)


def test_every_stream_unpacks_to_the_encoders_symbols(generated):
    """The port's streams.npz, range-coded with the saved priors by the
    native coder, unpack to the written symbols."""
    got, path = generated["port"]
    books = tckpt.load_codebooks(path, "cpu")
    sizes = trate.codebook_sizes(books)
    priors = tckpt.load_priors(path)
    orders = tnative.scalar_orders(books)
    z = np.load(os.path.join(got["out_dir"], "streams.npz"))
    for u in range(int(z["n_utterances"])):
        idx = {k: z[f"u{u}_idx_{k}"] for k in ("scl", "scl_bl", "vq",
                                               "vq_bl")}
        payload = tnative.pack_utterance_rc(
            z[f"u{u}_ind1"], z[f"u{u}_ind2"], idx, z[f"u{u}_pcodes"], sizes,
            priors=priors, orders=orders)
        back = tnative.unpack_utterance_rc(payload, sizes, priors=priors,
                                           orders=orders)
        np.testing.assert_array_equal(back["ind1"], z[f"u{u}_ind1"])
        np.testing.assert_array_equal(back["ind2"], z[f"u{u}_ind2"])
        for k, v in idx.items():
            np.testing.assert_array_equal(back["indices"][k], v, err_msg=k)


def test_generated_features_train_the_vocoder(work, generated):
    """tests/test_entries.py:119-134 for the port: the coded windows
    finetune the vocoder's frame net (train.upd_f_only)."""
    got, path = generated["port"]
    _, cfg = _cfgs(work, path, ["train.upd_f_only=true", "train.epochs=1",
                                "train.debugging=true", "label=coded"])
    cfg.train.transfer_model = None           # it names the predictor
    model, loss = ttl.run(cfg, data_dir=got["out_dir"], device="cpu")
    assert np.isfinite(loss)


def test_collect_priors_and_static_coder_match_jax(generated):
    """collect_priors (three- and four-tuples), build_models,
    entropy_pack / entropy_unpack: JAX's counts and bytes exactly; the
    native module's collect_priors is the range coder's."""
    assert tnative.collect_priors is trc.collect_priors
    assert tnative.build_models is trc.build_models
    got, path = generated["port"]
    books = tckpt.load_codebooks(path, "cpu")
    sizes = trate.codebook_sizes(books)
    orders = trc.scalar_orders(books)
    z = np.load(os.path.join(got["out_dir"], "streams.npz"))
    streams = [(z[f"u{u}_ind1"], z[f"u{u}_ind2"],
                {k: z[f"u{u}_idx_{k}"] for k in ("scl", "scl_bl", "vq",
                                                 "vq_bl")},
                z[f"u{u}_pcodes"]) for u in range(4)]
    for items in (streams, [s[:3] for s in streams]):
        want = jrc.collect_priors(items, sizes, orders=orders)
        have = trc.collect_priors(items, sizes, orders=orders)
        assert sorted(have) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(have[k], v, err_msg=k)
    counts = {"ind1": np.array([3.0, 5.0]), "ind2": np.array([4.0, 4.0]),
              "scl": np.arange(1.0, 9.0), "scl_bl": np.ones(4),
              **{f"vq_{s}": np.arange(8.0) + 1 for s in range(2)},
              "vq_bl_0": np.full(8, 2.0)}
    jm, tm = jrc.build_models(counts), trc.build_models(counts)
    for i1, i2, ix, _ in streams:
        data = trc.entropy_pack(i1, i2, ix, tm)
        assert data == jrc.entropy_pack(i1, i2, ix, jm)
        back = trc.entropy_unpack(data, len(i1), tm, 2, 1)
        want = jrc.entropy_unpack(data, len(i1), jm, 2, 1)
        for k, v in (("ind1", i1), ("ind2", i2)):
            np.testing.assert_array_equal(back[k], want[k])
            np.testing.assert_array_equal(back[k], v.astype(bool))
        for k in want["indices"]:
            np.testing.assert_array_equal(back["indices"][k],
                                          want["indices"][k], err_msg=k)


def test_coded_feature_windows_match_jax():
    """Both track lengths: chunks with their context rows, and a plain
    track whose context rows are edge-replicated."""
    rng = np.random.RandomState(3)
    for length in (2 * 15 + 4, 3 * 15):
        coded = (rng.randn(2, length, 20) * 0.02).astype(np.float32)
        want = jcodec.coded_feature_windows(jnp.asarray(coded))
        got = tcodec.coded_feature_windows(torch.as_tensor(coded))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g[..., :20], w[..., :20])
            np.testing.assert_allclose(g[..., 20:], w[..., 20:], atol=1e-3)


def test_frame_evaluation_matches_jax(work, books):
    jcfg, tcfg = _cfgs(work, books[0][0], ["train.debugging=true"])
    want = jfe.run(jcfg, max_batches=2)
    got = tfe.run(tcfg, max_batches=2, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3, (k, got[k], v)


def _jax_uniforms_by_utterance():
    """The uniforms of JAX's synthesis_qtz: utterance ns draws
    (L, 1, 160) from PRNGKey(ns)."""
    calls = []

    def uniforms(frames, batch):
        key = jax.random.PRNGKey(len(calls))
        calls.append(frames)
        return np.array(jax.random.uniform(key, (frames, batch,
                                                 C.FRAME_SIZE)))

    return uniforms


@pytest.mark.parametrize("entropy", [True, False])
def test_synthesis_qtz_matches_jax(work, books, generated, entropy):
    """The whole chain, range-coded with the priors generate_qtz_features
    collected, or fixed-layout."""
    path = books[0][0]
    jcfg, tcfg = _cfgs(work, path,
                       [f"codec.entropy_coding={str(entropy).lower()}"])
    voc = jlpcnet.init_lpcnet(jax.random.PRNGKey(12), JVOC)
    priors = generated["jax"][0]["priors"] if entropy else None
    jdir = str(work / f"sq_jax_{entropy}")
    tdir = str(work / f"sq_port_{entropy}")
    want = jsq.run(jcfg, num_samples=2, out_dir=jdir, vocoder_params=voc,
                   use_pallas=False, priors=priors)
    got = tsq.run(tcfg, num_samples=2, out_dir=tdir,
                  vocoder_params=jax.tree_util.tree_map(np.asarray, voc),
                  priors=priors, device="cpu",
                  uniforms=_jax_uniforms_by_utterance())
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        assert g["packed"] == w["packed"]
        assert g["bitrate"] == w["bitrate"]
        gw = np.load(os.path.join(tdir, f"{g['name']}_features.npy"))
        ww = np.load(os.path.join(jdir, f"{w['name']}_features.npy"))
        np.testing.assert_allclose(gw[..., :20], ww[..., :20], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(gw[..., 20:], ww[..., 20:], atol=1e-3)
        flips, err = trajectory_flips(g["wav"][None],
                                      np.asarray(w["wav"])[None])
        print(f"{g['name']}: first flip {flips[0]}, {err:.3g} before it")
        for suffix in ("truth", "dec"):
            assert os.path.exists(os.path.join(tdir,
                                               f"{g['name']}_{suffix}.wav"))


def test_decimation_helpers_match_jax():
    rng = np.random.RandomState(2)
    for length, dec in ((10, 1), (11, 2), (17, 3)):
        send = trate.send_pattern(length, dec)
        np.testing.assert_array_equal(send, jrate.send_pattern(length, dec))
        ind1, ind2 = rng.rand(length) > 0.5, rng.rand(length) > 0.5
        idx = {"scl": rng.randint(0, 8, length),
               "vq": rng.randint(0, 8, (length, 2))}
        pc = rng.randint(0, 8, (length, 2))
        got = trate.decimate_streams(ind1, ind2, idx, pc, send)
        want = jrate.decimate_streams(ind1, ind2, idx, pc, send)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(g, w)
        unpacked = {"ind1": got[0], "ind2": got[1], "indices": got[2],
                    "pitch": rng.rand(int(send.sum()), 2),
                    "lost": rng.rand(int(send.sum())) > 0.7}
        g, w = (m.expand_streams(unpacked, send) for m in (trate, jrate))
        for k in ("ind1", "ind2", "lost", "pitch"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in w["indices"]:
            np.testing.assert_array_equal(g["indices"][k], w["indices"][k])


def test_frontier_and_selection_match_jax():
    rng = np.random.RandomState(4)
    points = [{"preset": f"p{i}", "scale": float(s), "l1": 0.09 * s,
               "l2": 0.28 * s, "bps": float(b), "mse": float(m)}
              for i, (s, b, m) in enumerate(zip(
                  rng.rand(12) + 0.3, rng.rand(12) * 2000 + 500,
                  rng.rand(12)))]
    assert trate.pareto_frontier(points) == jrate.pareto_frontier(points)
    for target in (100.0, 900.0, 1500.0, 5000.0):
        assert trate.select_preset(points, target) == \
            jrate.select_preset(points, target)
        assert trate.select_scale(points, target) == \
            jrate.select_scale(points, target)


def test_operating_points_match_jax(work, books):
    """measure_rd_surface over three presets (`lean` with a decimating
    variant) at two scales on the corpus's first batch."""
    path = books[0][0]
    jbooks = jckpt.load_codebooks(path)
    tbooks = tckpt.load_codebooks(path, "cpu")
    params = jckpt.restore_params(
        jfp.init_frame_predictor(jax.random.PRNGKey(0),
                                 jfp.FramePredictorConfig(gru_units1=32,
                                                          gru_units2=16)),
        jckpt.load(jckpt.checkpoint_path(str(work / "runs"), "pred", 0)))
    model = weights.predictor_from_params(
        jax.tree_util.tree_map(np.asarray, params))
    ds = jds.build_dataset(_cfgs(work, path)[0].data, "train")
    feat = jds.predictor_inputs(next(ds.iter_batches(2, seed=0)))
    presets = {k: trate.PRESETS[k] for k in ("full", "lean")}
    presets["lean_dec"] = dict(trate.PRESETS["lean"], decimate=2)
    want = jrate.measure_rd_surface(params, jbooks, feat, presets=presets,
                                    scales=(0.5, 1.5))
    got = trate.measure_rd_surface(model, tbooks, feat, presets=presets,
                                   scales=(0.5, 1.5))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in ("preset", "scale", "l1", "l2", "bps", "sizes", "decimate"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["mse"], w["mse"], rtol=1e-5)
        for k, v in w["priors"].items():
            np.testing.assert_array_equal(g["priors"][k], v, err_msg=k)
    assert trate.select_preset(got, 1200.0)["preset"] == \
        jrate.select_preset(want, 1200.0)["preset"]


def test_entry_points_run_on_the_cpu_when_asked(work, books, tmp_path):
    """Every pipeline entry's main on --device=cpu, one batch."""
    path = str(tmp_path / "cb.npz")
    shutil.copy(books[0][1], path)
    args = _overrides(work, path, ["train.debugging=true", "train.epochs=1",
                                   "label=cli", f"train.save_dir={tmp_path}"])
    args = [a for a in args if not a.startswith("train.transfer")]
    from fpsc_tpu_torch.train import train_frame as ttf
    for mod in (ttf, ttc, tgq, tfe, tsq):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.main(args)
        assert mod.main(args + ["--device=cpu"]) == 0, mod.__name__
    assert tckpt.load_priors(path) is not None
