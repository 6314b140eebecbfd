"""The port's evaluation metrics against JAX's.

fpsc_tpu_torch/eval/{metrics,rtf,stoi,nsim}.py against fpsc_tpu's on
the same seeded waveforms.  Tolerances:

* coded_feature_mse, stft_log_spectral_distance, segmental_snr (numpy
  in both packages): equal;
* log_spectral_distance (f32 cepstra, the port's frontend on the CPU):
  rtol 1e-5;
* stoi and nsim (numpy float64 copies): within 1e-12 of JAX's; the
  vectorised paths against their loop oracles as tests/test_stoi.py and
  tests/test_nsim.py hold JAX's (1e-12, 1e-10);
* rtf: the same keys and arithmetic.
"""
import numpy as np
import pytest
import torch

from fpsc_tpu.data.synthetic import speech_like_waveform, synth_waveform
from fpsc_tpu.eval import metrics as jm
from fpsc_tpu.eval import nsim as jns
from fpsc_tpu.eval import rtf as jrtf
from fpsc_tpu.eval import stoi as jst

from fpsc_tpu_torch.dsp.frontend import frame_signal
from fpsc_tpu_torch.eval import metrics as tm
from fpsc_tpu_torch.eval import nsim as tns
from fpsc_tpu_torch.eval import rtf as trtf
from fpsc_tpu_torch.eval import stoi as tst
from fpsc_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread: the test workers share the host's
    cores."""
    with torch_threads(1):
        yield


def _speech(seconds, seed):
    n = int(16000 * seconds)
    x = np.asarray(speech_like_waveform(np.random.RandomState(seed), n),
                   np.float64)
    return x / (np.abs(x).max() + 1e-9)


def _pair(seconds, seed, snr_db):
    """A clean speech-like waveform and the same under another talker at
    snr_db."""
    x = _speech(seconds, seed)
    noise = _speech(seconds, seed + 40)[:len(x)]
    g = 10.0 ** (-snr_db / 20.0) * np.std(x) / np.std(noise)
    return x, x + g * noise


def test_frame_signal_is_jax():
    from fpsc_tpu.dsp.frontend import frame_signal as jframe
    x = synth_waveform(np.random.RandomState(1), 4000)
    np.testing.assert_array_equal(frame_signal(x), jframe(x))
    assert frame_signal(x[:100]).shape == (0, 320)


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_equal_jax(seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(2, 10, 20).astype(np.float32)
    b = a + 0.1 * rng.randn(2, 10, 20).astype(np.float32)
    assert tm.coded_feature_mse(a, b) == jm.coded_feature_mse(a, b)
    x = synth_waveform(np.random.RandomState(seed + 2), 8000)
    y = x + 0.05 * rng.randn(len(x)).astype(np.float32)
    assert (tm.stft_log_spectral_distance(x, y)
            == jm.stft_log_spectral_distance(x, y))
    assert tm.stft_log_spectral_distance(x[:100], y) == 0.0
    assert tm.segmental_snr(x, y) == jm.segmental_snr(x, y)


def test_log_spectral_distance_matches_jax():
    x = synth_waveform(np.random.RandomState(1), 4000)
    rng = np.random.RandomState(5)
    for y in (x + 0.05 * rng.randn(len(x)).astype(np.float32),
              x[::-1].copy()):
        got = tm.log_spectral_distance(x, y, device="cpu")
        assert got == pytest.approx(jm.log_spectral_distance(x, y),
                                    rel=1e-5)
    assert tm.log_spectral_distance(x, x, device="cpu") < 1e-5


def test_log_spectral_distance_runs_on_the_card_by_default():
    """device=None is the card: without one it raises, as every entry
    point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    x = synth_waveform(np.random.RandomState(1), 4000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.log_spectral_distance(x, x)


def test_rtf():
    assert trtf.synthesis_rtf(128, 16000, 1.0) == 128.0
    assert (trtf.synthesis_rtf(8, 32000, 0.37)
            == jrtf.synthesis_rtf(8, 32000, 0.37))
    calls = []
    got = trtf.measure(lambda: calls.append(1), reps=5, warmup=2)
    assert len(calls) == 7
    assert set(got) == {"min_s", "median_s", "max_s"}
    assert got["min_s"] <= got["median_s"] <= got["max_s"]


# ------------------------------------------------------------------- STOI

def test_stoi_pieces_equal_jax():
    x, y = _pair(2.0, 1, 5.0)
    x10, y10 = tst._to_10k(x, 16000), tst._to_10k(y, 16000)
    np.testing.assert_array_equal(x10, jst._to_10k(x, 16000))
    np.testing.assert_array_equal(tst._hann(256), jst._hann(256))
    xs, ys = tst.remove_silent_frames(x10, y10)
    wxs, wys = jst.remove_silent_frames(x10, y10)
    np.testing.assert_array_equal(xs, wxs)
    np.testing.assert_array_equal(ys, wys)
    obm = tst.thirdoct_band_matrix()
    np.testing.assert_array_equal(obm, jst.thirdoct_band_matrix())
    np.testing.assert_array_equal(tst._band_envelopes(xs, obm),
                                  jst._band_envelopes(xs, obm))


def test_stoi_vectorized_matches_loop_oracle():
    """tests/test_stoi.py's oracle case, on the port's functions."""
    x = _speech(2.0, 1)
    y = x + 0.1 * np.random.RandomState(2).randn(len(x))
    xs, ys = tst.remove_silent_frames(tst._to_10k(x, 16000),
                                      tst._to_10k(y, 16000))
    obm = tst.thirdoct_band_matrix()
    xe, ye = tst._band_envelopes(xs, obm), tst._band_envelopes(ys, obm)
    fast = float(tst._clip_and_correlate(
        tst._segment_stack(xe),
        np.ascontiguousarray(tst._segment_stack(ye))).mean())
    assert fast == pytest.approx(tst._stoi_segments_loop(xe, ye), abs=1e-12)
    assert fast == pytest.approx(jst._stoi_segments_loop(xe, ye), abs=1e-12)


@pytest.mark.parametrize("seed,snr_db", [(4, 30.0), (5, 0.0), (6, -10.0)])
def test_stoi_matches_jax(seed, snr_db):
    x, y = _pair(1.5, seed, snr_db)
    assert tst.stoi(x, y) == pytest.approx(jst.stoi(x, y), abs=1e-12)


def test_stoi_axioms():
    x = _speech(2.0, 3)
    assert tst.stoi(x, x) == pytest.approx(1.0, abs=1e-6)
    scores = [tst.stoi(*_pair(2.0, 4, snr)) for snr in (30.0, 0.0, -10.0)]
    assert scores[0] > 0.9 and scores[0] > scores[1] > scores[2]
    with pytest.raises(ValueError, match="too short"):
        tst.stoi(x[:3200], x[:3200])


# ------------------------------------------------------------------- NSIM

def test_nsim_pieces_equal_jax():
    np.testing.assert_array_equal(tns.erb_space(), jns.erb_space())
    for fc in (100.0, 2000.0):
        np.testing.assert_array_equal(tns.gammatone_fir(fc),
                                      jns.gammatone_fir(fc))
    x = _speech(0.5, 7)
    np.testing.assert_array_equal(tns.neurogram(x), jns.neurogram(x))
    # another rate goes through the port's resampler, JAX's copy
    np.testing.assert_array_equal(tns.neurogram(x[:4000], 8000),
                                  jns.neurogram(x[:4000], 8000))


def test_nsim_map_matches_loop_oracle():
    """tests/test_nsim.py's oracle case, on the port's functions."""
    rng = np.random.RandomState(0)
    r = rng.rand(12, 17) * 60.0
    d = np.clip(r + rng.randn(12, 17) * 6.0, 0.0, 60.0)
    fast = tns.nsim_map(r, d)
    assert fast.shape == (10, 15)
    assert np.abs(fast - tns._nsim_map_loop(r, d)).max() < 1e-10
    np.testing.assert_array_equal(fast, jns.nsim_map(r, d))


@pytest.mark.parametrize("seed,snr_db", [(4, 30.0), (5, 0.0)])
def test_nsim_matches_jax(seed, snr_db):
    x, y = _pair(1.0, seed, snr_db)
    assert tns.nsim(x, y) == pytest.approx(jns.nsim(x, y), abs=1e-12)


def test_nsim_axioms():
    x = _speech(1.5, 5)
    assert tns.nsim(x, x) == pytest.approx(1.0, abs=1e-9)
    assert tns.nsim(x, 0.25 * x) == pytest.approx(1.0, abs=1e-9)
    with pytest.raises(ValueError, match="too short"):
        tns.nsim(np.zeros(100), np.zeros(100))
