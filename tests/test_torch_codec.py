"""The port's `.fpsc` decoder end to end against the JAX file codec.

The JAX package writes every artifact, as a deployment would: codebooks
(.npz), a predictor and a vocoder checkpoint (`checkpoint.save`, with
an optax optimizer state), and a fixed-layout `.fpsc` of three
utterances from `cli.encode_paths` (two of one length and one of
another, so two buckets).  JAX's `cli.decode_file(use_pallas=False)` is
the oracle; the port loads the same files through its own unpickler
and decodes on the CPU with JAX's uniform stream.  Widths are the TINY
ones of tests/test_file_codec.py.

The predictor's output layer is scaled down so that the decoded
cepstra stay at speech scale (a random full-scale head gives cepstra of
up to 2 * MAXI = 48, which overflow the f32 power spectrum).

Tolerances: coded features rtol 1e-4, atol 1e-5, as
tests/test_file_codec.py:131 uses for the closed-loop decode.  LPC
against JAX's ceps2lpc of the port's features at atol 1e-3: on these
frames Levinson is ill-conditioned in f32 (given one f32
autocorrelation, JAX's and the port's Levinson part by 3.5e-4, each
2.8e-4 from a float64 one), so the LPC carries no more digits than
that, and the audio is compared with the vocoder JAX's decode_file runs
on the CPU, lpcnet.generate, on the port's features and LPC: the
sampler's trajectory contract, with no item diverging within its first
frame (160 samples).  The random vocoder's audio peaks above 5, not 1,
and the f32 rounding of the LPC prediction drifts in proportion, so the
contract's atol of 1e-5 is taken relative to the peak.

The flagship stream (`flagship_stream`) is what the JAX encoder writes
at its default settings: range-coded (`codec.entropy_coding=true`),
with entropy-model priors stored beside the codebooks, for a bunch=2
vocoder whose GRU_A recurrent matrix is block-sparse (GRU_A 128, so
that (64, 64) blocks leave auto_block_pattern a pattern; GRU_B 8).
The port decodes it through the block-sparse bunch=2 sampler, JAX's
CPU decoder through lpcnet_bunched.generate (dense), the same function.
The same container decoded through a bunch=4 vocoder (a JAX
init_bunched4 checkpoint, block-sparse, saved beside the first) takes
the bunch=4 sampler, and JAX's CPU decoder lpcnet_bunched.generate4.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fpsc_tpu.codec import bitstream as jbs
from fpsc_tpu.codec import cli as jcli
from fpsc_tpu.codec import container as jcontainer
from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.dsp import ceps2lpc as jceps
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.models import lpcnet as jlpcnet
from fpsc_tpu.models import lpcnet_bunched as jlb
from fpsc_tpu.train import checkpoint as jckpt

from fpsc_tpu_torch.codec import bitstream as tbs
from fpsc_tpu_torch.codec import cli as tcli
from fpsc_tpu_torch.codec import container as tcontainer
from fpsc_tpu_torch.codec import range_coder as trc
from fpsc_tpu_torch.config.config import Config as TConfig
from fpsc_tpu_torch.config.config import apply_overrides as tapply
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models.lpcnet_bunched import Bunched4LPCNet
from fpsc_tpu_torch.ops import lpcnet_sampler as ts
from fpsc_tpu_torch.train import checkpoint as tckpt
from fpsc_tpu_torch.utils.device import torch_threads

from test_file_codec import TINY, _write_artifacts, _write_wav


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores, and a thread pool in each
    spins against the others."""
    with torch_threads(1):
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_uniforms(frames, batch):
    """The stream of the JAX decoder's PRNGKey(0), (L, B, 160)."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                       (frames, batch, C.FRAME_SIZE)))


@pytest.fixture(scope="module")
def coded_stream(tmp_path_factory):
    """JAX-written artifacts and .fpsc, the overrides naming them, and
    JAX's decode of it."""
    tmp = tmp_path_factory.mktemp("codec")
    cb_path = _write_artifacts(tmp)
    save_dir = str(tmp / "runs")
    pred = jfp.init_frame_predictor(
        jax.random.PRNGKey(11),
        jfp.FramePredictorConfig(gru_units1=32, gru_units2=16))
    pred = pred._replace(fc=pred.fc._replace(w=pred.fc.w * 0.05,
                                             b=pred.fc.b * 0.05))
    voc = jlpcnet.init_lpcnet(
        jax.random.PRNGKey(12),
        jlpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                             cond_units=16))
    for label, params in (("pred", pred), ("voc", voc)):
        jckpt.save(jckpt.checkpoint_path(save_dir, label, 1), params,
                   opt_state=optax.adam(1e-3).init(params), step=3)
    overrides = TINY + [
        f"codec.codebook_path={cb_path}", "codec.entropy_coding=false",
        f"train.save_dir={save_dir}", "train.transfer_model=pred",
        "train.transfer_epoch=1", "train.vocoder_model=voc",
        "train.vocoder_epoch=1"]
    wavs = [_write_wav(tmp, "u1", seconds=0.3, seed=7),
            _write_wav(tmp, "u2", seconds=0.3, seed=8),
            _write_wav(tmp, "u3", seconds=0.4, seed=9)]
    jcfg = japply(JConfig(), overrides)
    *arts, jvoc = jcli.load_artifacts(jcfg, need_vocoder=True)
    path = str(tmp / "s.fpsc")
    jcli.encode_paths(jcfg, wavs, path, artifacts=arts)
    want = jcli.decode_file(jcfg, path, str(tmp / "jax_wav"),
                            use_pallas=False, artifacts=arts,
                            vocoder_params=jvoc)
    return dict(tmp=tmp, path=path, overrides=overrides, want=want,
                vocoder=jvoc)


def test_decode_file_matches_jax(coded_stream):
    cfg = tapply(TConfig(), coded_stream["overrides"])
    out_dir = coded_stream["tmp"] / "port_wav"
    got = tcli.decode_file(cfg, coded_stream["path"], str(out_dir),
                           device="cpu", uniforms=_jax_uniforms)
    want = coded_stream["want"]
    assert [g["name"] for g in got] == [w["name"] for w in want] \
        == ["u1", "u2", "u3"]
    buckets = {}
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["coded"], w["coded"], rtol=1e-4,
                                   atol=1e-5)
        _, lpc, _ = jceps.ceps2lpc(jnp.asarray(g["coded"][:, :18] * C.MAXI))
        np.testing.assert_allclose(g["lpc"], np.asarray(lpc), rtol=1e-4,
                                   atol=1e-3)
        assert g["wav"].shape == w["wav"].shape
        assert (out_dir / f"{g['name']}.wav").exists()
        buckets.setdefault(len(g["coded"]), []).append(g)
    assert len(buckets) == 2
    for items in buckets.values():
        coded = np.stack([g["coded"] for g in items])
        coded_un = coded * C.MAXI
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).astype(np.int32)
        ref = np.asarray(jlpcnet.generate(
            coded_stream["vocoder"], jnp.asarray(coded),
            jnp.asarray(periods),
            jnp.asarray(np.stack([g["lpc"] for g in items])),
            jax.random.PRNGKey(0), corr=jnp.asarray(coded_un[..., 19])))
        flips, _ = ts.trajectory_flips(np.stack([g["wav"] for g in items]),
                                       ref, atol=1e-5 * np.abs(ref).max())
        assert all(f is None or f >= C.FRAME_SIZE for f in flips), flips


FLAGSHIP = ["lpcnet.bunch=2", "lpcnet.gru_a_units=128",
            "lpcnet.gru_b_units=8", "lpcnet.embed_dim=16",
            "lpcnet.cond_units=16", "codec.entropy_coding=true"]


@pytest.fixture(scope="module")
def flagship_stream(tmp_path_factory):
    """A range-coded .fpsc from JAX's encode_paths with priors, a JAX
    bunch=2 block-sparse vocoder checkpoint, and JAX's decode."""
    tmp = tmp_path_factory.mktemp("flagship")
    cb_path = _write_artifacts(tmp)
    rng = np.random.RandomState(12)
    sizes = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}

    def stream(frames):
        ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.5
        idx = {"scl": np.where(ind1, rng.randint(0, 16, frames), -1),
               "scl_bl": np.where(ind1, -1, rng.randint(0, 4, frames)),
               "vq": np.where(ind2[:, None], rng.randint(0, 16, (frames, 2)),
                              -1),
               "vq_bl": np.where(ind2[:, None], -1,
                                 rng.randint(0, 8, (frames, 1)))}
        pcodes = np.stack([rng.randint(0, 256, frames),
                           rng.randint(0, 8, frames)], 1)
        return ind1, ind2, idx, pcodes

    books = jckpt.load_codebooks(cb_path)
    jckpt.save_priors(cb_path, jrc.collect_priors(
        [stream(60) for _ in range(3)], sizes,
        orders=jrc.scalar_orders(books)))
    save_dir = str(tmp / "runs")
    pred = jfp.init_frame_predictor(
        jax.random.PRNGKey(11),
        jfp.FramePredictorConfig(gru_units1=32, gru_units2=16))
    pred = pred._replace(fc=pred.fc._replace(w=pred.fc.w * 0.05,
                                             b=pred.fc.b * 0.05))
    voc = jlb.sparsify_gru_a(jlb.init_bunched(
        jax.random.PRNGKey(13),
        jlpcnet.LPCNetConfig(gru_a_units=128, gru_b_units=8, embed_dim=16,
                             cond_units=16)), 0.2, block=(64, 64))
    for label, params in (("pred", pred), ("voc", voc)):
        jckpt.save(jckpt.checkpoint_path(save_dir, label, 1), params,
                   opt_state=optax.adam(1e-3).init(params), step=3)
    overrides = TINY + FLAGSHIP + [
        f"codec.codebook_path={cb_path}", f"train.save_dir={save_dir}",
        "train.transfer_model=pred", "train.transfer_epoch=1",
        "train.vocoder_model=voc", "train.vocoder_epoch=1"]
    wavs = [_write_wav(tmp, "f1", seconds=0.3, seed=7),
            _write_wav(tmp, "f2", seconds=0.4, seed=8)]
    jcfg = japply(JConfig(), overrides)
    *arts, jvoc = jcli.load_artifacts(jcfg, need_vocoder=True)
    assert arts[2] is not None          # the priors
    path = str(tmp / "flagship.fpsc")
    jcli.encode_paths(jcfg, wavs, path, artifacts=arts)
    assert jcontainer.read_fpsc(path)["meta"]["entropy"]
    want = jcli.decode_file(jcfg, path, str(tmp / "jax_wav"),
                            use_pallas=False, artifacts=arts,
                            vocoder_params=jvoc)
    return dict(tmp=tmp, path=path, overrides=overrides, want=want,
                vocoder=jvoc)


def test_decode_file_matches_jax_on_the_flagship_stream(flagship_stream):
    """A range-coded container at the JAX encoder's default settings,
    decoded through a bunch=2 block-sparse vocoder carried over from a
    JAX checkpoint: JAX's coded features and LPC, and audio under the
    trajectory contract."""
    cfg = tapply(TConfig(), flagship_stream["overrides"])
    *artifacts, vocoder = tcli.load_artifacts(cfg, need_vocoder=True,
                                              device="cpu")
    assert artifacts[3] is not None
    pattern = ts.auto_block_pattern(vocoder)
    assert pattern is not None and pattern[1] == (64, 64)
    got = tcli.decode_file(cfg, flagship_stream["path"],
                           str(flagship_stream["tmp"] / "port_wav"),
                           artifacts=artifacts, vocoder=vocoder,
                           device="cpu", uniforms=_jax_uniforms)
    want = flagship_stream["want"]
    assert [g["name"] for g in got] == [w["name"] for w in want] \
        == ["f1", "f2"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["coded"], w["coded"], rtol=1e-4,
                                   atol=1e-5)
        _, lpc, _ = jceps.ceps2lpc(jnp.asarray(g["coded"][:, :18] * C.MAXI))
        np.testing.assert_allclose(g["lpc"], np.asarray(lpc), rtol=1e-4,
                                   atol=1e-3)
        coded_un = g["coded"][None] * C.MAXI
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).astype(np.int32)
        ref = np.asarray(jlb.generate(
            flagship_stream["vocoder"], jnp.asarray(g["coded"][None]),
            jnp.asarray(periods), jnp.asarray(g["lpc"][None]),
            jax.random.PRNGKey(0), corr=jnp.asarray(coded_un[..., 19])))
        assert g["wav"].shape == w["wav"].shape == ref[0].shape
        flips, _ = ts.trajectory_flips(g["wav"][None], ref,
                                       atol=1e-5 * np.abs(ref).max())
        assert all(f is None or f >= C.FRAME_SIZE for f in flips), flips


def test_decode_file_matches_jax_at_bunch_4(flagship_stream):
    """The flagship's container decoded at lpcnet.bunch=4 through a
    block-sparse bunch=4 vocoder from a JAX checkpoint (the unpickler's
    Bunched4Params): JAX's coded features and LPC, and audio under the
    trajectory contract against generate4, JAX's CPU sampler."""
    tmp = flagship_stream["tmp"]
    voc4 = jlb.sparsify_gru_a4(jlb.init_bunched4(
        jax.random.PRNGKey(14),
        jlpcnet.LPCNetConfig(gru_a_units=128, gru_b_units=8, embed_dim=16,
                             cond_units=16)), 0.2, block=(64, 64))
    jckpt.save(jckpt.checkpoint_path(str(tmp / "runs"), "voc4", 1), voc4,
               opt_state=optax.adam(1e-3).init(voc4), step=3)
    overrides = flagship_stream["overrides"] + [
        "lpcnet.bunch=4", "train.vocoder_model=voc4"]
    jcfg = japply(JConfig(), overrides)
    *arts, jvoc = jcli.load_artifacts(jcfg, need_vocoder=True)
    assert isinstance(jvoc, jlb.Bunched4Params)
    want = jcli.decode_file(jcfg, flagship_stream["path"],
                            str(tmp / "jax_wav4"), use_pallas=False,
                            artifacts=arts, vocoder_params=jvoc)
    cfg = tapply(TConfig(), overrides)
    *artifacts, vocoder = tcli.load_artifacts(cfg, need_vocoder=True,
                                              device="cpu")
    assert isinstance(vocoder, Bunched4LPCNet)
    pattern = ts.auto_block_pattern(vocoder)
    assert pattern is not None and pattern[1] == (64, 64)
    got = tcli.decode_file(cfg, flagship_stream["path"],
                           str(tmp / "port_wav4"), artifacts=artifacts,
                           vocoder=vocoder, device="cpu",
                           uniforms=_jax_uniforms)
    assert [g["name"] for g in got] == [w["name"] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["coded"], w["coded"], rtol=1e-4,
                                   atol=1e-5)
        _, lpc, _ = jceps.ceps2lpc(jnp.asarray(g["coded"][:, :18] * C.MAXI))
        np.testing.assert_allclose(g["lpc"], np.asarray(lpc), rtol=1e-4,
                                   atol=1e-3)
        coded_un = g["coded"][None] * C.MAXI
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).astype(np.int32)
        ref = np.asarray(jlb.generate4(
            jvoc, jnp.asarray(g["coded"][None]), jnp.asarray(periods),
            jnp.asarray(g["lpc"][None]), jax.random.PRNGKey(0),
            corr=jnp.asarray(coded_un[..., 19])))
        assert g["wav"].shape == w["wav"].shape == ref[0].shape
        flips, _ = ts.trajectory_flips(g["wav"][None], ref,
                                       atol=1e-5 * np.abs(ref).max())
        assert all(f is None or f >= C.FRAME_SIZE for f in flips), flips


def test_bitstream_and_container_match_jax(tmp_path):
    """The port's copies write JAX's bytes and read them back."""
    rng = np.random.RandomState(3)
    sizes = {"scl": 256, "scl_bl": 16, "vq": [1024, 1024], "vq_bl": [512]}
    frames = 40
    ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.3
    idx = {"scl": np.where(ind1, rng.randint(0, 256, frames), -1),
           "scl_bl": np.where(ind1, -1, rng.randint(0, 16, frames)),
           "vq": np.where(ind2[:, None], rng.randint(0, 1024, (frames, 2)),
                          -1),
           "vq_bl": np.where(ind2[:, None], -1,
                             rng.randint(0, 512, (frames, 1)))}
    pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                      rng.uniform(-0.5, 0.5, frames)], 1).astype(np.float32)
    payload = tbs.pack_utterance(ind1, ind2, idx, pitch, sizes)
    assert payload == jbs.pack_utterance(ind1, ind2, idx, pitch, sizes)
    got, want = (m.unpack_utterance(payload, sizes) for m in (tbs, jbs))
    for k in ("ind1", "ind2", "pitch"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in want["indices"]:
        np.testing.assert_array_equal(got["indices"][k], want["indices"][k])

    utts = [("a", payload), ("b", payload[:7])]
    for i, kw in enumerate([dict(entropy=False),
                            dict(entropy=True, preset="lean", l1=0.1)]):
        tp, jp = str(tmp_path / f"t{i}.fpsc"), str(tmp_path / f"j{i}.fpsc")
        tcontainer.write_fpsc(tp, utts, sizes, **kw)
        jcontainer.write_fpsc(jp, utts, sizes, **kw)
        with open(tp, "rb") as f, open(jp, "rb") as g:
            assert f.read() == g.read()
        assert tcontainer.read_fpsc(jp) == jcontainer.read_fpsc(jp)


def _tiny_cfg(tmp_path, extra=()):
    cb_path = _write_artifacts(tmp_path)
    return tapply(TConfig(), TINY + [f"codec.codebook_path={cb_path}",
                                     *extra])


def _port_stream(path, sizes, frames=3, **kw):
    """A container of one utterance of random symbols, written by the
    port."""
    rng = np.random.RandomState(4)
    ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.5
    idx = {"scl": rng.randint(0, sizes["scl"], frames),
           "scl_bl": rng.randint(0, sizes["scl_bl"], frames),
           "vq": np.stack([rng.randint(0, e, frames) for e in sizes["vq"]],
                          1),
           "vq_bl": np.stack([rng.randint(0, e, frames)
                              for e in sizes["vq_bl"]], 1)}
    pitch = np.stack([rng.uniform(-1.3, 3.7, frames),
                      rng.uniform(-0.5, 0.5, frames)], 1)
    payload = tbs.pack_utterance(ind1, ind2, idx, pitch, sizes)
    if kw.get("packet_frames"):
        payload = [payload]
        kw["frame_counts"] = {"x": frames}
    tcontainer.write_fpsc(path, [("x", payload)], sizes, **kw)
    return path


TINY_SIZES = {"scl": 16, "scl_bl": 4, "vq": [32, 16], "vq_bl": [8]}


def _range_coded_stream(tmp_path):
    """A range-coded container of one utterance of random symbols,
    written by the port -> (.fpsc path, codebook path)."""
    cb_path = _write_artifacts(tmp_path)
    rng = np.random.RandomState(4)
    frames = 3
    ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.5
    idx = {"scl": np.where(ind1, rng.randint(0, 16, frames), -1),
           "scl_bl": np.where(ind1, -1, rng.randint(0, 4, frames)),
           "vq": np.where(ind2[:, None], rng.randint(0, 16, (frames, 2)), -1),
           "vq_bl": np.where(ind2[:, None], -1, rng.randint(0, 8, (frames, 1)))}
    pcodes = np.stack([rng.randint(0, 256, frames),
                       rng.randint(0, 8, frames)], 1)
    orders = trc.scalar_orders(tckpt.load_codebooks(cb_path))
    payload = trc.pack_utterance_rc(ind1, ind2, idx, pcodes, TINY_SIZES,
                                    orders=orders)
    path = str(tmp_path / "x.fpsc")
    tcontainer.write_fpsc(path, [("x", payload)], TINY_SIZES, entropy=True)
    return path, cb_path


def test_cli_main_decodes_a_range_coded_stream_at_bunch_2(tmp_path):
    """The decode drive at the flagship's settings: a range-coded
    container written by the port, lpcnet.bunch=2 on the command line."""
    path, cb_path = _range_coded_stream(tmp_path)
    out = tmp_path / "wav"
    assert tcli.main(["decode", path, str(out), *TINY,
                      f"codec.codebook_path={cb_path}", "lpcnet.bunch=2",
                      "--device=cpu"]) == 0
    assert (out / "x.wav").exists()


def test_cli_main_decodes_a_range_coded_stream_at_bunch_4(tmp_path):
    """The decode drive at bench.py's bunch4 settings: lpcnet.bunch=4
    lpcnet.gru_b_units=64 on the command line."""
    path, cb_path = _range_coded_stream(tmp_path)
    out = tmp_path / "wav"
    assert tcli.main(["decode", path, str(out), *TINY,
                      f"codec.codebook_path={cb_path}", "lpcnet.bunch=4",
                      "lpcnet.gru_b_units=64", "--device=cpu"]) == 0
    assert (out / "x.wav").exists()


def test_cli_main_decodes_on_cpu(tmp_path):
    cfg_args = TINY + [f"codec.codebook_path={_write_artifacts(tmp_path)}"]
    path = _port_stream(str(tmp_path / "x.fpsc"), TINY_SIZES,
                        entropy=False)
    out = tmp_path / "wav"
    assert tcli.main(["decode", path, str(out), *cfg_args,
                      "--device=cpu"]) == 0
    assert (out / "x.wav").exists()
    assert tcli.main(["encode", path]) == 2


def test_cli_main_encodes_on_cpu(tmp_path):
    """The encode drive: a wav in, a .fpsc out that JAX's decode_file
    reads, at the JAX CLI's default range-coded layout."""
    cfg_args = TINY + [f"codec.codebook_path={_write_artifacts(tmp_path)}"]
    wav = _write_wav(tmp_path, "x", seconds=0.2, seed=5)
    path = str(tmp_path / "x.fpsc")
    assert tcli.main(["encode", path, wav, *cfg_args, "--device=cpu"]) == 0
    assert tcontainer.read_fpsc(path)["meta"]["entropy"]
    got = jcli.decode_file(japply(JConfig(), cfg_args), path,
                           str(tmp_path / "wav"), use_pallas=False)
    assert [r["name"] for r in got] == ["x"]
    assert got[0]["wav"].shape == (19 * C.FRAME_SIZE,)


@pytest.mark.parametrize("container_kw,cfg_extra,match", [
    # bunch=3 is no vocoder; the refusal names those that run, up to
    # bunch=4
    (dict(entropy=False), ("lpcnet.bunch=3",), "bunch=4"),
    # a preset name rate_control.PRESETS does not know
    (dict(entropy=False), ("codec.preset=nonesuch",),
     "unknown rate preset 'nonesuch'"),
])
def test_decode_refuses_what_it_does_not_decode(tmp_path, container_kw,
                                                cfg_extra, match):
    cfg = _tiny_cfg(tmp_path, cfg_extra)
    path = _port_stream(str(tmp_path / "x.fpsc"), TINY_SIZES, **container_kw)
    with pytest.raises(ValueError, match=match):
        tcli.decode_file(cfg, path, str(tmp_path / "wav"), device="cpu")


class Foreign:
    pass


@pytest.mark.parametrize("payload", [{"params": Foreign()}, os.system])
def test_checkpoint_loader_refuses_foreign_classes(tmp_path, payload):
    path = tmp_path / "x.ckpt"
    path.write_bytes(pickle.dumps(payload))
    with pytest.raises(ValueError, match="does not accept"):
        tckpt.load(str(path))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, pkgutil, sys
import fpsc_tpu_torch
for m in pkgutil.walk_packages(fpsc_tpu_torch.__path__, "fpsc_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("fpsc_tpu_torch.codec.range_coder",
             "fpsc_tpu_torch.codec.native_rc",
             "fpsc_tpu_torch.codec.rate_control",
             "fpsc_tpu_torch.codec.plc",
             "fpsc_tpu_torch.ops.host_build",
             "fpsc_tpu_torch.models.lpcnet_bunched",
             "fpsc_tpu_torch.probes.timing",
             *(f"fpsc_tpu_torch.probes.probe_{p}" for p in
               ("gates", "draw_tail", "wide_store", "i8_matmul")),
             "fpsc_tpu_torch.probes.draw_parts",
             "fpsc_tpu_torch.probes.draw_sass",
             *(f"fpsc_tpu_torch.data.{m}" for m in
               ("f32", "synthetic", "dataset", "prepare", "native")),
             "fpsc_tpu_torch.dsp.lpc",
             "fpsc_tpu_torch.dsp.entropy",
             "fpsc_tpu_torch.quant.lbg",
             "fpsc_tpu_torch.dsp.gaussian",
             "fpsc_tpu_torch.dsp.stft",
             *(f"fpsc_tpu_torch.models.{m}" for m in
               ("wavenet", "wavenet_iaf", "frame_predictor_para",
                "attention")),
             *(f"fpsc_tpu_torch.train.{m}" for m in
               ("train_lpcnet", "train_frame", "train_cb",
                "generate_qtz_features", "frame_evaluation",
                "synthesis_qtz", "train_vocoder", "synthesis",
                "train_iaf", "train_all"))):
    assert name in sys.modules, name
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "fpsc_tpu"
             or n.startswith("fpsc_tpu."))
assert not bad, bad
print(len([n for n in sys.modules if n.startswith("fpsc_tpu_torch")]))
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stderr
    assert int(run.stdout.split()[-1]) >= 59


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _tiny_cfg(tmp_path)
    path = _port_stream(str(tmp_path / "x.fpsc"), TINY_SIZES, entropy=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.decode_file(cfg, path, str(tmp_path / "wav"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.load_artifacts(cfg, need_vocoder=True)


# Every stream JAX's CLI decodes beyond the whole-utterance `full` one:
# packets (codec.packet_ms), with in-band FEC, under simulated loss, and
# the rate presets.  The codebooks' scalar book has 128 entries, so that
# `ultra` coarsens it (to 64) and its value ranks; the priors JAX
# collects at the full geometry ride beside the books, except for
# `ultra` (JAX's coder refuses full-geometry scalar priors on coarsened
# books).
PRESET_SIZES = {"scl": 128, "scl_bl": 16, "vq": [32, 16], "vq_bl": [8]}
# case: (encoder overrides, decoder overrides, codebook file)
EVERY_STREAM = {
    "packets": (["codec.packet_ms=50"], [], "priors"),
    "packets_lossy": (["codec.packet_ms=50"],
                      ["codec.sim_drop=0.25", "codec.sim_seed=3"], "priors"),
    "fec_lossy": (["codec.packet_ms=50", "codec.fec=true"],
                  ["codec.sim_drop=0.25", "codec.sim_seed=3"], "priors"),
    "lean": (["codec.preset=lean"], [], "priors"),
    "ultra": (["codec.preset=ultra"], [], "plain"),
}


def _preset_books(rng):
    return jfp.Codebooks(
        scl=jnp.asarray(np.sort(rng.randn(128)).astype(np.float32) * 0.1),
        vq=(jnp.asarray(rng.randn(32, 17).astype(np.float32) * 0.1),
            jnp.asarray(rng.randn(16, 17).astype(np.float32) * 0.03)),
        scl_bl=jnp.asarray(np.sort(rng.randn(16)).astype(np.float32) * 0.02),
        vq_bl=(jnp.asarray(rng.randn(8, 17).astype(np.float32) * 0.02),))


def _random_symbols(rng, sizes, frames):
    ind1, ind2 = rng.rand(frames) > 0.5, rng.rand(frames) > 0.5
    idx = {"scl": np.where(ind1, rng.randint(0, sizes["scl"], frames), -1),
           "scl_bl": np.where(ind1, -1,
                              rng.randint(0, sizes["scl_bl"], frames)),
           "vq": np.where(ind2[:, None], np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq"]], 1), -1),
           "vq_bl": np.where(ind2[:, None], -1, np.stack(
               [rng.randint(0, e, frames) for e in sizes["vq_bl"]], 1))}
    pcodes = np.stack([rng.randint(0, 256, frames),
                       rng.randint(0, 8, frames)], 1)
    return ind1, ind2, idx, pcodes


@pytest.fixture(scope="module")
def every_stream(tmp_path_factory):
    """Codebooks with and without priors, JAX predictor and vocoder
    checkpoints, two wavs of different lengths."""
    tmp = tmp_path_factory.mktemp("every")
    rng = np.random.RandomState(21)
    books = _preset_books(rng)
    cb = {"plain": str(tmp / "cb.npz"), "priors": str(tmp / "cb_priors.npz")}
    for path in cb.values():
        jckpt.save_codebooks(path, books)
    jckpt.save_priors(cb["priors"], jrc.collect_priors(
        [_random_symbols(rng, PRESET_SIZES, 60) for _ in range(3)],
        PRESET_SIZES, orders=jrc.scalar_orders(books)))
    save_dir = str(tmp / "runs")
    pred = jfp.init_frame_predictor(
        jax.random.PRNGKey(11),
        jfp.FramePredictorConfig(gru_units1=32, gru_units2=16))
    pred = pred._replace(fc=pred.fc._replace(w=pred.fc.w * 0.05,
                                             b=pred.fc.b * 0.05))
    voc = jlpcnet.init_lpcnet(
        jax.random.PRNGKey(12),
        jlpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, embed_dim=16,
                             cond_units=16))
    for label, params in (("pred", pred), ("voc", voc)):
        jckpt.save(jckpt.checkpoint_path(save_dir, label, 1), params,
                   opt_state=optax.adam(1e-3).init(params), step=3)
    base = TINY + [f"train.save_dir={save_dir}", "train.transfer_model=pred",
                   "train.transfer_epoch=1", "train.vocoder_model=voc",
                   "train.vocoder_epoch=1", "codec.entropy_coding=true"]
    wavs = [_write_wav(tmp, "p1", seconds=0.3, seed=7),
            _write_wav(tmp, "p2", seconds=0.45, seed=8)]
    return dict(tmp=tmp, cb=cb, base=base, wavs=wavs, vocoder=voc)


def _recovery_report(out: str):
    return [line for line in out.splitlines() if "concealed" in line]


def _assert_decode_matches(got, want, vocoder):
    """The port's decode_file results against JAX's: coded features at
    the closed-loop tolerance, LPC against JAX's ceps2lpc of the port's
    features, audio under the trajectory contract against JAX's CPU
    sampler on the port's features and LPC, bucket by bucket."""
    assert [g["name"] for g in got] == [w["name"] for w in want]
    buckets = {}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["coded"], w["coded"], rtol=1e-4,
                                   atol=1e-5)
        _, lpc, _ = jceps.ceps2lpc(jnp.asarray(g["coded"][:, :18] * C.MAXI))
        np.testing.assert_allclose(g["lpc"], np.asarray(lpc), rtol=1e-4,
                                   atol=1e-3)
        assert g["wav"].shape == w["wav"].shape
        buckets.setdefault(len(g["coded"]), []).append(g)
    for items in buckets.values():
        coded = np.stack([g["coded"] for g in items])
        coded_un = coded * C.MAXI
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).astype(np.int32)
        ref = np.asarray(jlpcnet.generate(
            vocoder, jnp.asarray(coded), jnp.asarray(periods),
            jnp.asarray(np.stack([g["lpc"] for g in items])),
            jax.random.PRNGKey(0), corr=jnp.asarray(coded_un[..., 19])))
        flips, _ = ts.trajectory_flips(np.stack([g["wav"] for g in items]),
                                       ref, atol=1e-5 * np.abs(ref).max())
        assert all(f is None or f >= C.FRAME_SIZE for f in flips), flips


@pytest.mark.parametrize("case", list(EVERY_STREAM))
def test_decode_file_matches_jax_on_every_stream(every_stream, case,
                                                 capsys):
    """A stream JAX's encode_paths writes, decoded by JAX's
    decode_file(use_pallas=False) and by the port's on the CPU: JAX's
    features, LPC and audio, and JAX's recovery report word for word.
    Lossless packets decode to the whole-utterance stream's features bit
    for bit, as JAX pins."""
    enc, dec, cb = EVERY_STREAM[case]
    tmp = every_stream["tmp"]
    overrides = every_stream["base"] + [
        f"codec.codebook_path={every_stream['cb'][cb]}", *enc]
    jcfg = japply(JConfig(), overrides)
    *arts, jvoc = jcli.load_artifacts(jcfg, need_vocoder=True)
    path = str(tmp / f"{case}.fpsc")
    jcli.encode_paths(jcfg, every_stream["wavs"], path, artifacts=arts)
    meta = jcontainer.read_fpsc(path)["meta"]
    capsys.readouterr()
    want = jcli.decode_file(japply(JConfig(), overrides + dec), path,
                            str(tmp / f"jax_{case}"), use_pallas=False,
                            artifacts=arts, vocoder_params=jvoc)
    jax_report = _recovery_report(capsys.readouterr().out)
    got = tcli.decode_file(tapply(TConfig(), overrides + dec), path,
                           str(tmp / f"port_{case}"), device="cpu",
                           uniforms=_jax_uniforms)
    assert _recovery_report(capsys.readouterr().out) == jax_report
    assert bool(jax_report) == bool(dec)
    if "codec.fec=true" in enc:
        assert any(" 0 recovered" not in line for line in jax_report)
    _assert_decode_matches(got, want, every_stream["vocoder"])
    if case == "packets":
        plain_cfg = every_stream["base"] + [
            f"codec.codebook_path={every_stream['cb'][cb]}"]
        plain = str(tmp / "plain.fpsc")
        jcli.encode_paths(japply(JConfig(), plain_cfg), every_stream["wavs"],
                          plain, artifacts=arts)
        whole = tcli.decode_file(tapply(TConfig(), plain_cfg), plain,
                                 str(tmp / "port_plain"), device="cpu",
                                 uniforms=_jax_uniforms)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g["coded"], w["coded"])
    if case in ("lean", "ultra"):
        assert meta["preset"] == case
        assert meta["sizes"]["vq"] == [32] and meta["sizes"]["vq_bl"] == []
        assert meta["sizes"]["scl"] == (64 if case == "ultra" else 128)


def test_presets_are_jaxs():
    from fpsc_tpu.codec import rate_control as jrate
    from fpsc_tpu_torch.codec import rate_control as trate
    assert trate.PRESETS == jrate.PRESETS


@pytest.mark.parametrize("preset", ["full", "vq1", "novqbl", "lean", "ultra",
                                    "ultra2"])
def test_preset_codebooks_and_artifacts_are_jaxs(every_stream, preset):
    """preset_codebooks gives JAX's books exactly (the coarse scalar books
    by numpy's ranks of the sorted book), and load_artifacts JAX's
    sizes, value ranks and priors, those of dropped stages pruned."""
    from fpsc_tpu.codec import rate_control as jrate
    from fpsc_tpu_torch.codec import native_rc as tnative
    from fpsc_tpu_torch.codec import rate_control as trate
    overrides = every_stream["base"] + [
        f"codec.codebook_path={every_stream['cb']['priors']}",
        f"codec.preset={preset}"]
    jframe, jbooks, jpriors, jorders, _, jsizes = jcli.load_artifacts(
        japply(JConfig(), overrides))
    _, books, sizes, priors, orders, rcmod = tcli.load_artifacts(
        tapply(TConfig(), overrides), device="cpu")
    assert sizes == jsizes
    assert rcmod is tnative.best()
    assert sorted(orders) == sorted(jorders)
    for k in jorders:
        np.testing.assert_array_equal(orders[k], jorders[k])
    assert sorted(priors) == sorted(jpriors)
    for k in jpriors:
        np.testing.assert_array_equal(priors[k], jpriors[k])
    full = tckpt.load_codebooks(every_stream["cb"]["priors"])
    direct = trate.preset_codebooks(full, **trate.PRESETS[preset])
    for loaded in (books, direct):
        np.testing.assert_array_equal(loaded.scl.numpy(), jbooks.scl)
        np.testing.assert_array_equal(loaded.scl_bl.numpy(), jbooks.scl_bl)
        assert len(loaded.vq) == len(jbooks.vq)
        for a, b in zip(loaded.vq, jbooks.vq):
            np.testing.assert_array_equal(a.numpy(), b)
        assert (loaded.vq_bl is None) == (jbooks.vq_bl is None)
        for a, b in zip(loaded.vq_bl or (), jbooks.vq_bl or ()):
            np.testing.assert_array_equal(a.numpy(), b)
    coarse = jrate.PRESETS[preset].get("scl_entries")
    assert sizes["scl"] == (coarse or 128)
    # a book no larger than the entries asked for is kept as it is
    assert trate.coarsen_scalar(full.scl_bl, 16) is full.scl_bl


@pytest.mark.parametrize("config,n_utt,frames", [
    ("FLAGSHIP", 2, 20), ("PACKET_LOSS", 8, 200), ("SMALL_LOSS", 2, 20),
    ("ULTRA", 2, 20)])
def test_smoke_streams_come_back_as_written(tmp_path, config, n_utt, frames):
    """chip_smoke.py's streams at the reference geometry (whole
    utterances; packets with FEC at its main path's and its card-vs-CPU
    size and drop rate; the ultra preset) give the written symbols back
    through the port's coders, and its lossy channels drop packets."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    overrides = getattr(cs, config)
    cfg = cs._config(overrides, "")
    stream, cb_path, written = cs._write_stream(str(tmp_path), cfg, n_utt,
                                                frames, config)
    cfg = cs._config(overrides, cb_path)
    artifacts = tcli.load_artifacts(cfg, device="cpu")
    implied = cs._check_symbols(stream, cfg, artifacts, written)
    assert bool(implied) == (cfg.codec.sim_drop > 0)
    meta = tcontainer.read_fpsc(stream)["meta"]
    assert meta["preset"] == cfg.codec.preset
    assert meta["packet_frames"] == cfg.codec.packet_ms // 10
    if config == "ULTRA":
        assert meta["sizes"] == {"scl": 64, "scl_bl": 8, "vq": [1024],
                                 "vq_bl": []}
