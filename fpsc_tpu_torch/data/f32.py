""".f32 feature-dump ingestion.

A copy of fpsc_tpu/data/f32.py.  The interchange format is the LPCNet
dump_data layout the reference consumes (reference:
data_preprocess/write_small_files.py:18-24,42): flat float32 rows of 36
features per 10 ms frame [18 Bark cepstra | pitch period | pitch corr |
16 LPC], grouped into overlapping 19-row windows (15-frame hop, 2
lookback + 2 lookahead context rows) shaped (nb_chunks, 19, 36).
"""
from __future__ import annotations

import numpy as np

from fpsc_tpu_torch.dsp import constants as C

ROW = C.NB_FEATURES
WINDOW_ROWS = C.FRAMES_PER_CHUNK + 2 * C.CONTEXT_FRAMES  # 19


def read_f32(path: str) -> np.ndarray:
    """Read a raw .f32 dump into (total_frames, 36)."""
    flat = np.fromfile(path, dtype=np.float32)
    n = flat.size // ROW
    return flat[: n * ROW].reshape(n, ROW)


def write_f32(path: str, frames: np.ndarray) -> None:
    np.asarray(frames, np.float32).reshape(-1, ROW).tofile(path)


def _windows(frames: np.ndarray, n: int) -> np.ndarray:
    sizeof = frames.strides[-1]
    out = np.lib.stride_tricks.as_strided(
        frames,
        shape=(n, WINDOW_ROWS, ROW),
        strides=(C.FRAMES_PER_CHUNK * ROW * sizeof, ROW * sizeof, sizeof),
    )
    return np.ascontiguousarray(out)


def window_features(frames: np.ndarray) -> np.ndarray:
    """(total_frames, 36) -> (nb_chunks, 19, 36) overlapping windows.

    Window i covers frame rows [i*15, i*15 + 19); the count is chosen so
    that the last window stays in bounds (the reference's as_strided at
    write_small_files.py:62-66 can over-read its memmap by 4 rows; this
    clamps instead).
    """
    total = frames.shape[0]
    n = max(0, (total - 2 * C.CONTEXT_FRAMES) // C.FRAMES_PER_CHUNK)
    return _windows(frames, n)


def flatten_windows(windows: np.ndarray) -> np.ndarray:
    """(k, 19, 36) consecutive windows -> (k*15 + 4, 36) frame track
    with the 2+2 context rows from the first/last window (the reference
    dataset layout, dataset_orig.py:93-95)."""
    k = windows.shape[0]
    mid = windows[:, C.CONTEXT_FRAMES:-C.CONTEXT_FRAMES, :].reshape(-1, ROW)
    return np.concatenate(
        [windows[0, :C.CONTEXT_FRAMES], mid,
         windows[k - 1, -C.CONTEXT_FRAMES:]], axis=0)


def repack_windows(frames: np.ndarray, n_chunks: int) -> np.ndarray:
    """(n_chunks*15 + 4, 36) frame track -> (n_chunks, 19, 36) windows,
    the inverse of flatten_windows (reference
    generate_qtz_features.py:66-71 does this with as_strided)."""
    return _windows(np.ascontiguousarray(frames), n_chunks)
