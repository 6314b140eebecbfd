"""Parity of the port's data layer with the JAX package.

fpsc_tpu_torch/data/{f32,synthetic,dataset,prepare,native}.py against
fpsc_tpu/data/.  Inputs are made with numpy from a seed; the port's
analysis runs on the CPU.  Tolerances:

* f32 windows, the synthetic waveforms (the same numpy code and
  RandomState draws), dataset batches built from the same utterances
  (the same RandomState draws), directory loading, the quantised-pitch
  substitution and the native extractor (the same C++ source): exact;
* the synthetic fixtures' features, which come from each package's own
  analysis (JAX's f64 numpy oracle, the port's dsp/frontend.py): cepstra
  atol 1e-4, pitch lags identical but for knife-edge flips (at most 1%
  of the frames, and one), the correlations within 1e-4 and the LPC
  within 1e-3 where the lags agree (tests/test_torch_encode.py's
  bounds).
"""
import os
import wave

import numpy as np
import pytest
import torch

from fpsc_tpu.config.config import Config as JConfig
from fpsc_tpu.config.config import apply_overrides as japply
from fpsc_tpu.data import dataset as jds
from fpsc_tpu.data import f32 as jf32
from fpsc_tpu.data import native as jnative
from fpsc_tpu.data import prepare as jprep
from fpsc_tpu.data import synthetic as jsyn

from fpsc_tpu_torch.config.config import Config
from fpsc_tpu_torch.config.config import apply_overrides
from fpsc_tpu_torch.data import dataset as tds
from fpsc_tpu_torch.data import f32 as tf32
from fpsc_tpu_torch.data import native as tnative
from fpsc_tpu_torch.data import prepare as tprep
from fpsc_tpu_torch.data import synthetic as tsyn
from fpsc_tpu_torch.ops import host_build
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


STYLES = ["harmonic", "speech", "speech_hard"]


def _lags(pitch):
    return np.floor(0.1 + 50.0 * np.asarray(pitch)[:, 0] + 100.0)


def check_features(got, want) -> int:
    """The frontend bounds of the module docstring; returns the count
    of knife-edge pitch flips."""
    got, want = got.reshape(-1, 36), want.reshape(-1, 36)
    np.testing.assert_allclose(got[:, :18], want[:, :18], rtol=0, atol=1e-4)
    same = _lags(got[:, 18:20]) == _lags(want[:, 18:20])
    flips = int((~same).sum())
    assert flips <= max(1, len(same) // 100), flips
    np.testing.assert_allclose(got[same, 19], want[same, 19], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[same, 20:], want[same, 20:], rtol=0,
                               atol=1e-3)
    return flips


def _port_items(items):
    return [tds.Utterance(u.name, u.waveform, u.windows) for u in items]


def _same_batch(got, want):
    assert got["name"] == want["name"]
    for k in ("x", "feat", "nm_feat"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_f32_windows_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    frames = rng.randn(15 * 7 + 4 + 9, 36).astype(np.float32)
    win = tf32.window_features(frames)
    np.testing.assert_array_equal(win, jf32.window_features(frames))
    flat = tf32.flatten_windows(win)
    np.testing.assert_array_equal(flat, jf32.flatten_windows(win))
    np.testing.assert_array_equal(tf32.repack_windows(flat, win.shape[0]),
                                  jf32.repack_windows(flat, win.shape[0]))
    np.testing.assert_array_equal(tf32.repack_windows(flat, win.shape[0]),
                                  win)
    assert tf32.window_features(frames[:18]).shape == (0, 19, 36)
    # each package reads the other's dump
    tf32.write_f32(str(tmp_path / "a.f32"), frames)
    jf32.write_f32(str(tmp_path / "b.f32"), frames)
    np.testing.assert_array_equal(jf32.read_f32(str(tmp_path / "a.f32")),
                                  tf32.read_f32(str(tmp_path / "b.f32")))
    assert (tmp_path / "a.f32").read_bytes() == (tmp_path / "b.f32"
                                                 ).read_bytes()


@pytest.mark.parametrize("style", STYLES)
def test_synthetic_waveforms_match_jax(style):
    """The waveform generators, their phoneme plans and resonators,
    bit for bit from the same RandomState."""
    n = 9000
    if style == "harmonic":
        got = tsyn.synth_waveform(np.random.RandomState(3), n)
        want = jsyn.synth_waveform(np.random.RandomState(3), n)
    else:
        hard = style == "speech_hard"
        got = tsyn.speech_like_waveform(np.random.RandomState(3), n, hard)
        want = jsyn.speech_like_waveform(np.random.RandomState(3), n, hard)
        assert (tsyn._phoneme_plan(np.random.RandomState(4), n)
                == jsyn._phoneme_plan(np.random.RandomState(4), n))
        assert tsyn._resonator(700.0, 90.0) == jsyn._resonator(700.0, 90.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style", STYLES)
def test_synth_utterance_matches_jax(style):
    """The aligned waveform bit for bit; the windows by each package's
    analysis, within the frontend bounds (flips counted and printed)."""
    wav, windows = tsyn.synth_utterance(11, 12, style=style, device="cpu")
    jwav, jwindows = jsyn.synth_utterance(11, 12, style=style)
    np.testing.assert_array_equal(wav, jwav)
    assert windows.shape == jwindows.shape == (12, 19, 36)
    flips = check_features(tf32.flatten_windows(windows),
                           jf32.flatten_windows(jwindows))
    print(f"{style}: {flips} knife-edge pitch flips of "
          f"{12 * 15 + 4} frames")
    assert tsyn.synth_utterance(11, 12, style=style, device="cpu")[0] is wav


@pytest.fixture(scope="module")
def utterances():
    """JAX's synthetic utterances, three of 12 chunks; the third with a
    NaN window (the redraw guard) and one short one (tiling)."""
    items = jds.make_synthetic(3, chunks_each=12, seed=1)
    items[2].windows = items[2].windows.copy()
    items[2].windows[3, 5, 4] = np.nan
    short = jds.Utterance("short", items[0].waveform[:3 * 2400],
                          items[0].windows[:3])
    return items + [short]


BATCH_CASES = [("train", 2, False), ("train", 5, True), ("val", 2, False),
               ("train", 14, False)]


@pytest.mark.parametrize("task,chunks,qtz", BATCH_CASES)
def test_dataset_batches_match_jax(utterances, task, chunks, qtz):
    """iter_batches, sample_batch and the head crops of the same
    utterances, with the same seeds: the same batches, exactly
    (crops, tiling of short utterances, the NaN redraw, the quantised
    pitch substitution)."""
    want_ds = jds.Dataset(utterances, chunks, task, qtz_pitch=qtz)
    got_ds = tds.Dataset(_port_items(utterances), chunks, task,
                         qtz_pitch=qtz)
    assert len(got_ds) == len(want_ds) == 4
    for head in (False, True):
        for g, w in zip(got_ds.iter_batches(2, seed=5, head=head),
                        want_ds.iter_batches(2, seed=5, head=head)):
            _same_batch(g, w)
    _same_batch(got_ds.sample_batch(np.random.RandomState(8), 3),
                want_ds.sample_batch(np.random.RandomState(8), 3))
    b = got_ds.sample_batch(np.random.RandomState(8), 3)
    np.testing.assert_array_equal(tds.predictor_inputs(b),
                                  jds.predictor_inputs(b))
    np.testing.assert_array_equal(tds.predictor_inputs(b, False),
                                  jds.predictor_inputs(b, False))


def test_substitute_qtz_pitch_matches_jax():
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 34, 36).astype(np.float32)
    feat[..., 18] = rng.uniform(-1.5, 3.5, (2, 34))
    np.testing.assert_array_equal(tds.substitute_qtz_pitch(feat),
                                  jds.substitute_qtz_pitch(feat))


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype(np.int16).tobytes())


def test_load_directory_matches_jax(tmp_path):
    """.f32 dumps with .wav, .s16 or no audio beside them."""
    rng = np.random.RandomState(6)
    split = tmp_path / "train"
    split.mkdir()
    for i, ext in enumerate([".wav", ".s16", None]):
        frames = rng.randn(15 * (3 + i) + 4, 36).astype(np.float32)
        tf32.write_f32(str(split / f"u{i}.f32"), frames)
        x = (rng.randn(2400 * (3 + i)) * 0.2).clip(-1, 1)
        if ext == ".wav":
            _write_wav(split / f"u{i}.wav", x)
        elif ext == ".s16":
            (x * 32767).astype(np.int16).tofile(str(split / f"u{i}.s16"))
    got = tds.load_directory(str(tmp_path), "train")
    want = jds.load_directory(str(tmp_path), "train")
    assert [u.name for u in got] == [u.name for u in want] == [
        "u0", "u1", "u2"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.waveform, w.waveform)
        np.testing.assert_array_equal(g.windows, w.windows)


def _cfgs(overrides):
    jc, tc = JConfig(), Config()
    japply(jc, overrides)
    apply_overrides(tc, overrides)
    return jc, tc


@pytest.mark.parametrize("task", ["train", "val"])
def test_build_dataset_matches_jax(task):
    """build_dataset on synthetic fixtures: the same utterances (names,
    waveforms bit for bit, features within the frontend bounds) and,
    given the same items, the same batches."""
    jc, tc = _cfgs(["data.synthetic=true", "data.synthetic_utterances=4",
                    "data.chunks=2", "data.seed=3"])
    want = jds.build_dataset(jc.data, task)
    got = tds.build_dataset(tc.data, task, device="cpu")
    assert [u.name for u in got.items] == [u.name for u in want.items]
    assert len(got) == (4 if task == "train" else 2)
    for g, w in zip(got.items, want.items):
        np.testing.assert_array_equal(g.waveform, w.waveform)
        check_features(g.windows, w.windows)
    got.items = _port_items(want.items)
    _same_batch(next(got.iter_batches(2, seed=1)),
                next(want.iter_batches(2, seed=1)))


def test_build_dataset_refuses_shard_by_process():
    """data.shard_by_process, refused until the port had process groups:
    without a group the process is rank 0 of 1, as a single JAX process
    is, and the batches are JAX's."""
    jc, tc = _cfgs(["data.shard_by_process=true", "data.synthetic=true",
                    "data.synthetic_utterances=4", "data.chunks=2",
                    "data.seed=3"])
    want = jds.build_dataset(jc.data, "train")
    got = tds.build_dataset(tc.data, "train", device="cpu")
    assert (got.process_index, got.process_count) == (0, 1) == (
        want.process_index, want.process_count)
    got.items = _port_items(want.items)
    _same_batch(next(got.iter_batches(2, seed=1)),
                next(want.iter_batches(2, seed=1)))


def test_native_extractor_matches_jax():
    """The port's copy of the C++ extractor, built into build/host/,
    gives JAX's native rows exactly."""
    x = jsyn.synth_waveform(np.random.RandomState(9), 8000)
    np.testing.assert_array_equal(tnative.extract_features_native(x),
                                  jnative.extract_features_native(x))
    lib = tnative.load()
    assert os.path.dirname(lib._name) == str(host_build.HOST_DIR)
    assert lib._name == str(host_build.library_path(tnative.SOURCE))
    assert tnative.extract_features_native(x[:100]).shape == (0, 36)


def _raw_dir(tmp_path):
    raw = tmp_path / "raw"
    (raw / "sub").mkdir(parents=True)
    x = jsyn.synth_waveform(np.random.RandomState(2), 16000)
    (x * 32767).astype(np.int16).tofile(str(raw / "utt0.s16"))
    _write_wav(raw / "sub" / "utt1.wav",
               jsyn.speech_like_waveform(np.random.RandomState(4), 12000))
    (np.zeros(100, np.int16)).tofile(str(raw / "tiny.s16"))
    return raw


@pytest.mark.parametrize("backend,jax_backend", [("torch", "numpy"),
                                                 ("native", "native")])
def test_prepare_matches_jax(tmp_path, backend, jax_backend):
    """The prepared corpus: the same files, the pre-emphasised .s16
    byte for byte, the .f32 rows exactly (native) or within the frontend
    bounds (the port's batched frontend against JAX's f64 oracle); the
    dataset loader reads it."""
    raw = _raw_dir(tmp_path)
    n = tprep.prepare(str(raw), str(tmp_path / "port"), "train", backend,
                      device="cpu")
    assert n == jprep.prepare(str(raw), str(tmp_path / "jax"), "train",
                              jax_backend) == 2
    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert sorted(os.listdir(tmp_path / "port" / "train")) == names
    for name in names:
        got = (tmp_path / "port" / "train" / name).read_bytes()
        want = (tmp_path / "jax" / "train" / name).read_bytes()
        if name.endswith(".s16") or backend == "native":
            assert got == want, name
        else:
            check_features(np.frombuffer(got, np.float32),
                           np.frombuffer(want, np.float32))
    assert len(tds.load_directory(str(tmp_path / "port"), "train")) == 2


def test_prepare_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main([str(_raw_dir(tmp_path)), str(tmp_path / "out")])
    tprep.main([str(tmp_path / "raw"), str(tmp_path / "out"),
                "--device", "cpu"])
    assert len(os.listdir(tmp_path / "out" / "train")) == 4
    with pytest.raises(ValueError, match="torch or native"):
        tprep.prepare(str(tmp_path / "raw"), str(tmp_path / "x"), "train",
                      "jax")
