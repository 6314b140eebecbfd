"""ctypes binding to the port's native C++ feature extractor.

Port of fpsc_tpu/data/native.py.  The library is the port's copy of the
extractor (csrc/feature_extractor.cpp), built by g++ at first use into
build/host/ (ops/host_build.py), never into the JAX package's cpp/.
`extract_features_native(x) -> (n_frames, 36)` is the host-side
counterpart of dsp/frontend.py::extract_features.
"""
from __future__ import annotations

import ctypes

import numpy as np

from fpsc_tpu_torch.ops import host_build

SOURCE = "feature_extractor.cpp"
_BOUND = set()


def load() -> ctypes.CDLL:
    lib = host_build.load(SOURCE)
    if SOURCE not in _BOUND:
        lib.fe_extract_features.restype = ctypes.c_int
        lib.fe_extract_features.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        _BOUND.add(SOURCE)
    return lib


def extract_features_native(x: np.ndarray) -> np.ndarray:
    """x: (n_samples,) float32 in [-1, 1] -> (n_frames, 36)."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    n_frames = max(0, len(x) // 160 - 1)
    out = np.zeros((max(n_frames, 1), 36), np.float32)
    got = lib.fe_extract_features(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:got]
