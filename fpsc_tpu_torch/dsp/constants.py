"""DSP constants shared by the cepstrum <-> LPC frontend.

These mirror the LPCNet-derived analysis geometry used by the reference
codec (reference: src/ceps2lpc/ceps2lpc_vct.py:10-33 and
src/ceps2lpc/ceps2lpc_sc.py:14-34): 16 kHz audio, 10 ms frames (160
samples) with a 20 ms analysis window, 18 Bark-ish bands, LPC order 16.

Everything here is a *precomputed dense matrix* so that the whole
frontend becomes a couple of matmuls instead of the reference's
per-band Python loops.  A copy of fpsc_tpu/dsp/constants.py: the
PyTorch port keeps its own.
"""
from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000
FRAME_SIZE_5MS = 2
OVERLAP_SIZE_5MS = 2
WINDOW_SIZE_5MS = FRAME_SIZE_5MS + OVERLAP_SIZE_5MS
FRAME_SIZE = 80 * FRAME_SIZE_5MS          # 160 samples = 10 ms
OVERLAP_SIZE = 80 * OVERLAP_SIZE_5MS      # 160 samples
WINDOW_SIZE = FRAME_SIZE + OVERLAP_SIZE   # 320 samples = 20 ms
FREQ_SIZE = WINDOW_SIZE // 2 + 1          # 161 rfft bins
NB_BANDS = 18
LPC_ORDER = 16
NB_FEATURES = 36                          # 18 ceps + 2 pitch + 16 lpc
NB_USED_FEATURES = 20                     # 18 ceps + 2 pitch
MAXI = 24.1                               # feature normalisation constant
FRAMES_PER_CHUNK = 15
SAMPLES_PER_CHUNK = FRAMES_PER_CHUNK * FRAME_SIZE  # 2400
CONTEXT_FRAMES = 2                        # lookback == lookahead == 2

# Band edges in units of 4 FFT bins (i.e. 50 Hz at 16 kHz / 320-pt window).
EBAND5MS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40],
    dtype=np.int32,
)

# Per-band energy compensation for the triangular band overlap.
COMPENSATION = np.array(
    [0.8, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.666667, 0.5, 0.5, 0.5,
     0.333333, 0.25, 0.25, 0.2, 0.166667, 0.173913],
    dtype=np.float32,
)


def _dct_table() -> np.ndarray:
    """DCT-III (inverse DCT-II) basis used for Bark cepstra.

    table[i, j] = cos((i + .5) * j * pi / 18), first column scaled by
    sqrt(.5).  idct(x) = (x @ table.T) * sqrt(2/18).
    """
    i = np.arange(NB_BANDS)[:, None].astype(np.float64)
    j = np.arange(NB_BANDS)[None, :].astype(np.float64)
    table = np.cos((i + 0.5) * j * np.pi / NB_BANDS)
    table[:, 0] *= np.sqrt(0.5)
    return table.astype(np.float32)


DCT_TABLE = _dct_table()
IDCT_SCALE = np.sqrt(2.0 / NB_BANDS).astype(np.float32)


def _dct_fwd_table() -> np.ndarray:
    """Forward DCT-II basis: ceps = (bandE @ table) * sqrt(2/18)."""
    i = np.arange(NB_BANDS)[:, None].astype(np.float64)
    j = np.arange(NB_BANDS)[None, :].astype(np.float64)
    table = np.cos((i + 0.5) * j * np.pi / NB_BANDS)
    table[:, 0] *= np.sqrt(0.5)
    return table.astype(np.float32)


DCT_FWD_TABLE = _dct_fwd_table()


def _interp_matrix() -> np.ndarray:
    """(NB_BANDS, FREQ_SIZE) linear band->bin interpolation matrix.

    interp_band_gain(bandE) == bandE @ INTERP_MATRIX.  Bin 160 stays 0,
    matching the reference behaviour.
    """
    m = np.zeros((NB_BANDS, FREQ_SIZE), dtype=np.float64)
    for i in range(NB_BANDS - 1):
        band_size = int(EBAND5MS[i + 1] - EBAND5MS[i]) * WINDOW_SIZE_5MS
        for j in range(band_size):
            frac = j / band_size
            k = int(EBAND5MS[i]) * WINDOW_SIZE_5MS + j
            m[i, k] += 1.0 - frac
            m[i + 1, k] += frac
    return m.astype(np.float32)


INTERP_MATRIX = _interp_matrix()


def _band_energy_matrix() -> np.ndarray:
    """(FREQ_SIZE, NB_BANDS) triangular band-summation matrix.

    bandE = |X|^2 @ BAND_MATRIX reproduces LPCNet's compute_band_energy:
    each band accumulates triangularly-weighted bin energies from its
    two neighbouring edges.
    """
    m = np.zeros((FREQ_SIZE, NB_BANDS), dtype=np.float64)
    for i in range(NB_BANDS - 1):
        band_size = int(EBAND5MS[i + 1] - EBAND5MS[i]) * WINDOW_SIZE_5MS
        for j in range(band_size):
            frac = j / band_size
            k = int(EBAND5MS[i]) * WINDOW_SIZE_5MS + j
            m[k, i] += (1.0 - frac)
            m[k, i + 1] += frac
    return m.astype(np.float32)


BAND_MATRIX = _band_energy_matrix()

# -40 dB noise floor applied to ac[0] before Levinson-Durbin.
AC_NOISE_FLOOR = np.float32(320.0 / 12.0 / 38.0)
# Lag window (1 - 6e-5 * i^2) for i in 0..16.
LAG_WINDOW = (1.0 - 6e-5 * np.arange(LPC_ORDER + 1) ** 2).astype(np.float32)
