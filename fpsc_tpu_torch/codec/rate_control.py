"""Rate presets: reduced codebook sets decodable from the same trained
artifacts.

Port of fpsc_tpu/codec/rate_control.py:56-112 (`PRESETS`,
`coarsen_scalar`, `preset_codebooks`) on torch.Tensor codebooks.  A
preset drops the second above-threshold VQ stage and/or the whole
below-threshold VQ, and may coarsen the scalar gain books to fewer
quantile-subsampled entries; every pack/unpack layer parameterises by
the `sizes` dict of whatever books are present, so the preset name is
all a decoder needs.  Not ported yet (they run the encoder): frame
decimation (`send_pattern`, `decimate_streams`, `expand_streams`) and
the operating-point search.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fpsc_tpu_torch.models.frame_predictor import Codebooks

# codebook-subset presets, richest first.  vq_stages = above-threshold
# VQ stages kept; vq_bl = keep the below-threshold VQ stream;
# scl_entries / scl_bl_entries = coarsen the scalar gain books to that
# many quantile-subsampled entries; decimate = transmit only
# (decimate-1)/decimate of the frames (an encoder option; the codebooks
# ignore it).
PRESETS: Dict[str, Dict] = {
    "full":   {"vq_stages": None, "vq_bl": True},
    "vq1":    {"vq_stages": 1,    "vq_bl": True},
    "novqbl": {"vq_stages": None, "vq_bl": False},
    "lean":   {"vq_stages": 1,    "vq_bl": False},
    "ultra":  {"vq_stages": 1, "vq_bl": False, "scl_entries": 64,
               "scl_bl_entries": 8, "decimate": 3},
    "ultra2": {"vq_stages": 1, "vq_bl": False, "scl_entries": 64,
               "scl_bl_entries": 8, "decimate": 2},
}


def coarsen_scalar(cb: torch.Tensor, entries: int) -> torch.Tensor:
    """Quantile-subsample a trained scalar codebook to `entries` levels:
    evenly spaced ranks of the sorted book, endpoints kept.  The ranks
    are numpy's, as the JAX module takes them, so the entries match."""
    n = int(cb.shape[0])
    if entries >= n:
        return cb
    ranks = np.round(np.linspace(0, n - 1, entries)).astype(np.int64)
    return torch.sort(cb).values[torch.as_tensor(ranks, device=cb.device)]


def preset_codebooks(codebooks: Codebooks, vq_stages=None,
                     vq_bl: bool = True, scl_entries: int = None,
                     scl_bl_entries: int = None,
                     decimate: int = 1) -> Codebooks:
    """A reduced codebook set from the trained artifacts.  The scalar
    gains are always kept (they carry the envelope) but may be
    coarsened; vector stages are dropped.  `decimate` is accepted so
    that PRESETS specs pass through `**spec` unchanged."""
    del decimate
    vq = codebooks.vq if vq_stages is None else codebooks.vq[:vq_stages]
    scl = codebooks.scl if scl_entries is None else coarsen_scalar(
        codebooks.scl, scl_entries)
    scl_bl = codebooks.scl_bl
    if scl_bl is not None and scl_bl_entries is not None:
        scl_bl = coarsen_scalar(scl_bl, scl_bl_entries)
    return Codebooks(scl=scl, vq=tuple(vq), scl_bl=scl_bl,
                     vq_bl=codebooks.vq_bl if vq_bl else None)
