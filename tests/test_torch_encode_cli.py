"""The port's encode entry point against the JAX file codec, stream by
stream.

The JAX package writes the artifacts, as a deployment would: codebooks
(.npz) with and without entropy-model priors, a predictor checkpoint
(its head scaled down so that the cepstra stay at speech scale, as in
tests/test_torch_codec.py) and a vocoder checkpoint, at the TINY widths
of tests/test_file_codec.py; three speech-like wavs of two lengths (two
buckets).  JAX's `cli.encode_paths` and the port's, on the CPU, encode
the same wavs with the same artifacts and overrides, and must write the
same `.fpsc` bytes: fixed and range-coded layouts, packets with and
without FEC, the learned-mask path, and every rate preset.  Each
package's `decode_file` decodes the other's stream to the same coded
features (rtol 1e-4, atol 1e-5, tests/test_file_codec.py:131).  Both
refuse what JAX's encoder refuses, in the same words.
"""
import os

import numpy as np
import pytest

import jax
import optax

from fpsc_tpu.codec import cli as jcli
from fpsc_tpu.codec import container as jcontainer
from fpsc_tpu.codec import range_coder as jrc
from fpsc_tpu.codec import rate_control as jrate
from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.models import frame_predictor as jfp
from fpsc_tpu.models import lpcnet as jlpcnet
from fpsc_tpu.train import checkpoint as jckpt

from fpsc_tpu_torch.codec import cli as tcli
from fpsc_tpu_torch.config.config import Config as TConfig
from fpsc_tpu_torch.config.config import apply_overrides as tapply
from fpsc_tpu_torch.utils.device import torch_threads

from test_file_codec import TINY, _write_artifacts, _write_wav
from test_torch_codec import (PRESET_SIZES, TINY_SIZES, _jax_uniforms,
                              _preset_books, _random_symbols)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for a module of small tensors: the
    test workers share the host's cores."""
    with torch_threads(1):
        yield


CLOSED_LOOP = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """JAX-written codebooks (plain and with priors), predictor and
    vocoder checkpoints, and three wavs."""
    tmp = tmp_path_factory.mktemp("encode")
    cb = {"plain": _write_artifacts(tmp)}
    (tmp / "pri").mkdir()
    cb["priors"] = _write_artifacts(tmp / "pri")
    books = jckpt.load_codebooks(cb["priors"])
    rng = np.random.RandomState(13)
    jckpt.save_priors(cb["priors"], jrc.collect_priors(
        [_random_symbols(rng, TINY_SIZES, 60) for _ in range(3)],
        TINY_SIZES, orders=jrc.scalar_orders(books)))
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
                   "train.vocoder_epoch=1"]
    wavs = [_write_wav(tmp, "u1", seconds=0.3, seed=7),
            _write_wav(tmp, "u2", seconds=0.3, seed=8),
            _write_wav(tmp, "u3", seconds=0.4, seed=9)]
    return dict(tmp=tmp, cb=cb, base=base, wavs=wavs)


RANGE = ["codec.entropy_coding=true"]
# case: (overrides, codebook file)
STREAMS = {
    "fixed": (["codec.entropy_coding=false"], "plain"),
    "range_coded": (RANGE, "priors"),
    "range_coded_no_priors": (RANGE, "plain"),
    "packets": (RANGE + ["codec.packet_ms=50"], "priors"),
    "packets_fec": (RANGE + ["codec.packet_ms=50", "codec.fec=true"],
                    "priors"),
    "packets_fec_30ms": (RANGE + ["codec.packet_ms=30", "codec.fec=true"],
                         "priors"),
    "mask": (["codec.entropy_coding=false", "codec.use_mask=true"], "plain"),
    "mask_range_coded": (RANGE + ["codec.use_mask=true"], "priors"),
    "mask_packets_fec": (RANGE + ["codec.use_mask=true", "codec.packet_ms=50",
                                  "codec.fec=true"], "priors"),
    "thresholds": (RANGE + ["codec.l1=0.05", "codec.l2=0.15"], "priors"),
    **{f"preset_{p}": (RANGE + [f"codec.preset={p}"], "priors")
       for p in jrate.PRESETS if p != "full"},
    **{f"preset_{p}_fixed": (["codec.entropy_coding=false",
                              f"codec.preset={p}"], "plain")
       for p in ("lean", "ultra")},
}


def _overrides(fixture, case):
    extra, cb = STREAMS[case]
    return fixture["base"] + [f"codec.codebook_path={fixture['cb'][cb]}",
                              *extra]


def _symbols(path, overrides):
    """The port's decode-side unpack of every utterance -> {name: dict}."""
    cfg = tapply(TConfig(), overrides)
    _, _, sizes, priors, orders, rcmod = tcli.load_artifacts(cfg,
                                                             device="cpu")
    box = jcontainer.read_fpsc(path)
    meta, out = box["meta"], {}
    for name, payload in box["utterances"]:
        if meta["packet_frames"]:
            payload = b"".join(payload)     # compared as bytes only
            out[name] = payload
        elif meta["entropy"]:
            out[name] = rcmod.unpack_utterance_rc(payload, sizes,
                                                  priors=priors,
                                                  orders=orders)
        else:
            from fpsc_tpu_torch.codec import bitstream
            out[name] = bitstream.unpack_utterance(payload, sizes)
    return out


def _first_difference(jpath, tpath, overrides):
    """Where two containers part: the first frame of each utterance whose
    symbols differ, for the failure message."""
    want, got = _symbols(jpath, overrides), _symbols(tpath, overrides)
    where = {}
    for name in want:
        w, g = want[name], got.get(name)
        if isinstance(w, bytes) or g is None:
            if w != g:
                where[name] = "payload"
            continue
        rows = [np.flatnonzero(np.asarray(w[k]) != np.asarray(g[k]))
                for k in ("ind1", "ind2")]
        rows += [np.flatnonzero((np.asarray(w["indices"][k])
                                 != np.asarray(g["indices"][k])).reshape(
                                     len(w["ind1"]), -1).any(1))
                 for k in w["indices"]]
        rows.append(np.flatnonzero((w["pitch"] != g["pitch"]).any(1)))
        first = [int(r[0]) for r in rows if len(r)]
        if first:
            where[name] = min(first)
    return where


def _encode_both(fixture, case, capsys):
    overrides = _overrides(fixture, case)
    tmp = fixture["tmp"]
    jpath, tpath = str(tmp / f"jax_{case}.fpsc"), str(tmp / f"port_{case}.fpsc")
    jcfg = japply(JConfig(), overrides)
    capsys.readouterr()
    want = jcli.encode_paths(jcfg, fixture["wavs"], jpath)
    jax_report = capsys.readouterr().out
    got = tcli.encode_paths(tapply(TConfig(), overrides), fixture["wavs"],
                            tpath, device="cpu")
    port_report = capsys.readouterr().out.replace("port_", "jax_")
    return overrides, jpath, tpath, want, got, jax_report, port_report


@pytest.mark.parametrize("case", list(STREAMS))
def test_encode_paths_writes_jaxs_bytes(fixture, case, capsys):
    """The same container byte for byte, the same rates, sizes and
    report.  No knife edge is expected on these inputs: a difference
    fails, naming the first frame where each utterance's symbols part."""
    overrides, jpath, tpath, want, got, jax_report, port_report = \
        _encode_both(fixture, case, capsys)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        jbytes, tbytes = f.read(), g.read()
    assert jbytes == tbytes, _first_difference(jpath, tpath, overrides)
    assert got["bytes"] == want["bytes"] == len(jbytes)
    assert got["sizes"] == want["sizes"]
    assert got["rates"] == pytest.approx(want["rates"], rel=0, abs=0)
    assert port_report == jax_report
    meta = jcontainer.read_fpsc(tpath)["meta"]
    assert [n for n, _ in jcontainer.read_fpsc(tpath)["utterances"]] \
        == ["u1", "u2", "u3"]
    extra = STREAMS[case][0]
    assert meta["entropy"] == ("codec.entropy_coding=true" in extra)
    assert meta["use_mask"] == ("codec.use_mask=true" in extra)
    assert meta["fec"] == ("codec.fec=true" in extra)


@pytest.mark.parametrize("case", ["range_coded", "packets_fec", "mask"])
def test_each_package_decodes_the_others_stream(fixture, case, capsys):
    """JAX's decode_file on the port's stream and the port's on JAX's:
    the same coded features."""
    overrides, jpath, tpath, *_ = _encode_both(fixture, case, capsys)
    tmp = fixture["tmp"]
    jcfg = japply(JConfig(), overrides)
    *arts, jvoc = jcli.load_artifacts(jcfg, need_vocoder=True)
    jax_of_port = jcli.decode_file(jcfg, tpath, str(tmp / f"jd_{case}"),
                                   use_pallas=False, artifacts=arts,
                                   vocoder_params=jvoc)
    port_of_jax = tcli.decode_file(tapply(TConfig(), overrides), jpath,
                                   str(tmp / f"td_{case}"), device="cpu",
                                   uniforms=_jax_uniforms)
    assert [r["name"] for r in jax_of_port] == \
        [r["name"] for r in port_of_jax] == ["u1", "u2", "u3"]
    for w, g in zip(jax_of_port, port_of_jax):
        np.testing.assert_allclose(g["coded"], w["coded"], **CLOSED_LOOP)
        assert g["coded"].shape[0] in (29, 39)


def _priors_books(tmp):
    """128-entry scalar books, which `ultra` coarsens, with priors
    collected at the full geometry."""
    rng = np.random.RandomState(21)
    books = _preset_books(rng)
    path = str(tmp / "cb_full_priors.npz")
    jckpt.save_codebooks(path, books)
    jckpt.save_priors(path, jrc.collect_priors(
        [_random_symbols(rng, PRESET_SIZES, 60) for _ in range(3)],
        PRESET_SIZES, orders=jrc.scalar_orders(books)))
    return path


REFUSALS = {
    "duplicate basenames": ([], "plain", ValueError),
    "packets without entropy coding": (
        ["codec.entropy_coding=false", "codec.packet_ms=50"], "plain",
        ValueError),
    "fec without packets": (RANGE + ["codec.fec=true"], "priors",
                            ValueError),
    "too short": ([], "plain", ValueError),
    # ROADMAP Queue C, settled: JAX's coder refuses full-geometry scalar
    # priors on the coarsened books (range_coder._prior_table)
    "ultra with full-geometry priors": (RANGE + ["codec.preset=ultra"],
                                        "full_priors", AssertionError),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_encode_refuses_what_jax_refuses(fixture, case, tmp_path):
    extra, cb, error = REFUSALS[case]
    cb_path = (_priors_books(tmp_path) if cb == "full_priors"
               else fixture["cb"][cb])
    overrides = fixture["base"] + [f"codec.codebook_path={cb_path}", *extra]
    wavs = list(fixture["wavs"])
    if case == "duplicate basenames":
        (tmp_path / "other").mkdir()
        wavs.append(_write_wav(tmp_path / "other", "u1", seconds=0.2,
                               seed=3))
    if case == "too short":
        from scipy.io import wavfile
        short = str(tmp_path / "short.wav")
        wavfile.write(short, 16000, (np.random.RandomState(3).randn(240)
                                     * 3000).astype(np.int16))
        wavs.append(short)
    with pytest.raises(error) as want:
        jcli.encode_paths(japply(JConfig(), overrides), wavs,
                          str(tmp_path / "j.fpsc"))
    with pytest.raises(error) as got:
        tcli.encode_paths(tapply(TConfig(), overrides), wavs,
                          str(tmp_path / "t.fpsc"), device="cpu")
    assert str(got.value) == str(want.value)
    if error is AssertionError:
        # a scalar prior of the full geometry (16 counts) where the
        # coarsened book's table has 8
        assert str(got.value) == "((16,), 8)"
    assert not os.path.exists(tmp_path / "t.fpsc")


def test_encode_needs_a_card_unless_asked_for_the_cpu(fixture):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tapply(TConfig(), _overrides(fixture, "fixed"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.encode_paths(cfg, fixture["wavs"],
                          str(fixture["tmp"] / "no_card.fpsc"))


def test_encode_timings_name_every_phase(fixture):
    timings = {}
    tcli.encode_paths(tapply(TConfig(), _overrides(fixture, "packets_fec")),
                      fixture["wavs"], str(fixture["tmp"] / "timed.fpsc"),
                      device="cpu", timings=timings)
    assert list(timings) == ["read", "analysis", "encode", "fec", "pack",
                             "write"]
    assert all(v >= 0 for v in timings.values())
