"""Utterance-level codec: features -> index streams -> coded frames.

Port of fpsc_tpu/codec/codec.py:37-137 (the reference's enc_features /
dec_features path, src/generate_qtz_features.py:49-91): `encode` runs
the closed-loop predictor with in-loop scalar and m-best VQ
quantisation, on the threshold or the learned-mask path; `decode`
rebuilds the same coded frames from the transmitted symbols alone; both
build no autograd graph.  `coded_feature_windows` turns coded frames
into the LPCNet-layout windows that vocoder training reads.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fpsc_tpu_torch.data.f32 import repack_windows
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.quant.scalar import scl_dequantize
from fpsc_tpu_torch.quant.vq import vq_dequantize


@torch.no_grad()
def encode(model: fp.FramePredictor, codebooks: fp.Codebooks,
           feat: torch.Tensor, l1: float = 0.09, l2: float = 0.28,
           use_mask: bool = False, scale: float = 1000.0,
           pitch_lag: int = 0, send=None) -> Dict:
    """feat: (B, L, 20) normalised [ceps | pitch] frames -> coded
    (B, L, 20) normalised coded frames, r_qtz (B, L, 18) the quantised
    residual, r the raw one, ind1 / ind2 (B, L) bool, indices (the index
    streams, -1 = unused) and counts (per-codebook usage).  `send`
    (threshold path only): the frame-decimation pattern of
    frame_predictor.encoder."""
    if use_mask:
        if send is not None:
            raise ValueError("decimation rides the threshold path")
        out = fp.mask_enc(model, feat, scale=scale, codebooks=codebooks,
                          qtz=True, pitch_lag=pitch_lag)
        ind1 = out["scl_mask"][..., 0] > 0.5
        ind2 = out["vct_mask"][..., 0] > 0.5
        r_qtz, r = out["r"], out["r_orig"]   # mask_enc's key layout
    else:
        out = fp.encoder(model, feat, l1=l1, l2=l2, codebooks=codebooks,
                         qtz=True, pitch_lag=pitch_lag, send=send)
        ind1, ind2 = out["ind1"], out["ind2"]
        r_qtz, r = out["r_qtz"], out["r"]
    return {"coded": out["c_in"], "r_qtz": r_qtz, "r": r, "ind1": ind1,
            "ind2": ind2, "indices": out["indices"],
            "counts": fp.usage_counts(codebooks, out["indices"])}


def dequantize_residual(codebooks: fp.Codebooks, ind1: torch.Tensor,
                        ind2: torch.Tensor, indices: Dict
                        ) -> torch.Tensor:
    """Index streams -> (B, L, 18) dequantised residuals: per frame the
    above- or below-threshold books, chosen by ind1 (c0) and ind2
    (c1..c17); -1 marks a book that was not used."""
    def safe(idx):
        return torch.clamp(idx, min=0)

    r0 = scl_dequantize(safe(indices["scl"]), codebooks.scl)
    if codebooks.scl_bl is not None:
        r0_below = scl_dequantize(safe(indices["scl_bl"]), codebooks.scl_bl)
    else:
        r0_below = torch.zeros_like(r0)
    r0 = torch.where(ind1, r0, r0_below)

    rv = vq_dequantize(safe(indices["vq"]), codebooks.vq)
    if codebooks.vq_bl is not None:
        rv_below = vq_dequantize(safe(indices["vq_bl"]), codebooks.vq_bl)
    else:
        rv_below = torch.zeros_like(rv)
    rv = torch.where(ind2[..., None], rv, rv_below)
    return torch.cat([r0[..., None], rv], dim=-1)


@torch.no_grad()
def decode(model: fp.FramePredictor, codebooks: fp.Codebooks,
           ind1: torch.Tensor, ind2: torch.Tensor, indices: Dict,
           pitch: torch.Tensor, pitch_lag: int = 0) -> torch.Tensor:
    """ind1/ind2 (B, L) bool, index streams, pitch (B, L, 2) ->
    (B, L, 20) normalised coded frames.  On the card the closed loop
    replays the predictor's captured chunks (frame_predictor.decoder;
    grad mode is off here)."""
    r_qtz = dequantize_residual(codebooks, ind1, ind2, indices)
    return fp.decoder(model, pitch, r_qtz, pitch_lag=pitch_lag)


def coded_feature_windows(coded: torch.Tensor) -> List[np.ndarray]:
    """(B, L, 20) normalised coded frames -> a list of B (n_chunks, 19,
    36) LPCNet-layout windows, the LPC recomputed from the CODED
    cepstra (ceps2lpc on coded's device).  L is n_chunks * 15 + 4 with
    the context rows included, or a plain n_chunks * 15 track, whose
    context rows are then edge-replicated."""
    coded_un = np.asarray(coded.detach().cpu()) * C.MAXI
    b, length, _ = coded_un.shape
    flat = coded_un.reshape(-1, coded_un.shape[-1])
    with torch.no_grad():
        _, lpc, _ = ceps2lpc(torch.as_tensor(
            np.ascontiguousarray(flat[:, :C.NB_BANDS]), device=coded.device))
    rows = np.concatenate([flat, lpc.cpu().numpy()], axis=1).reshape(
        b, length, C.NB_FEATURES)
    out = []
    for track in rows:
        if (length - 2 * C.CONTEXT_FRAMES) % C.FRAMES_PER_CHUNK == 0 and \
                length % C.FRAMES_PER_CHUNK != 0:
            n_chunks = (length - 2 * C.CONTEXT_FRAMES) // C.FRAMES_PER_CHUNK
        else:
            n_chunks = length // C.FRAMES_PER_CHUNK
            track = np.concatenate([
                np.repeat(track[:1], C.CONTEXT_FRAMES, axis=0), track,
                np.repeat(track[-1:], C.CONTEXT_FRAMES, axis=0)], axis=0)
        out.append(repack_windows(track, n_chunks))
    return out
