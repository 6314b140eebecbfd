"""Rate control: rate presets, frame decimation and measured
rate-distortion operating points.

Port of fpsc_tpu/codec/rate_control.py:56-335 on torch.Tensor
codebooks and the port's encoder.  A preset drops the second
above-threshold VQ stage and/or the whole below-threshold VQ, and may
coarsen the scalar gain books to fewer quantile-subsampled entries;
every pack/unpack layer parameterises by the `sizes` dict of whatever
books are present, so the preset name is all a decoder needs.  Frame
decimation (`send_pattern`, `decimate_streams`, `expand_streams`, host
numpy) transmits (decimate - 1) / decimate of the frames.  The search
(`measure_operating_points`, `measure_rd_surface`) encodes a
calibration batch at a grid of threshold scales through codec.encode on
the predictor's device and range-codes every utterance with priors
collected from the same batch (in-sample, as each preset would ship
them): measured b/s and coded-feature MSE; `pareto_frontier`,
`select_preset` and `select_scale` pick among the points.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import native_rc
from fpsc_tpu_torch.codec.codec import encode
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models.frame_predictor import Codebooks, codebook_sizes

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


def send_pattern(length: int, decimate: int) -> np.ndarray:
    """(L,) bool transmission pattern: every decimate-th frame is
    skipped (receiver free-runs through it).  Frame 0 always sends;
    decimate=1 sends everything."""
    send = np.ones(length, bool)
    if decimate > 1:
        send[decimate - 1::decimate] = False
    return send


def decimate_streams(ind1, ind2, indices: Dict, pcodes,
                     send: np.ndarray):
    """Subsample one utterance's symbol streams to the transmitted
    frames (feed the result to any pack_* layer unchanged)."""
    keep = np.asarray(send, bool)
    return (np.asarray(ind1)[keep], np.asarray(ind2)[keep],
            {k: np.asarray(v)[keep] for k, v in indices.items()},
            np.asarray(pcodes)[keep])


def expand_streams(got: Dict, send: np.ndarray) -> Dict:
    """Inverse of decimate_streams on the receiver: scatter unpacked
    kept-frame streams back to full length.  Skipped frames come back
    as untransmitted (-1 indices, False indicators) and are marked in
    `lost` — decode them with plc.conceal_decode(damp=1,
    energy_cap=False, fade_step=0), which is arithmetically the
    encoder's own feedback on those frames."""
    send = np.asarray(send, bool)
    length = len(send)
    kept = int(send.sum())
    out = {"ind1": np.zeros(length, bool),
           "ind2": np.zeros(length, bool),
           "lost": ~send,
           "indices": {}}
    out["ind1"][send] = np.asarray(got["ind1"])[:kept]
    out["ind2"][send] = np.asarray(got["ind2"])[:kept]
    for k, v in got["indices"].items():
        v = np.asarray(v)
        full = np.full((length,) + v.shape[1:], -1, v.dtype)
        full[send] = v[:kept]
        out["indices"][k] = full
    if "pitch" in got:
        p = np.asarray(got["pitch"])
        full = np.zeros((length,) + p.shape[1:], p.dtype)
        full[send] = p[:kept]
        # hold the last transmitted pitch through the gaps (what both
        # the encoder conditioning and conceal_decode expect)
        for t in range(1, length):
            if not send[t]:
                full[t] = full[t - 1]
        out["pitch"] = full
    # transport losses on top of decimation: a lost KEPT frame is lost
    if "lost" in got:
        lost_kept = np.asarray(got["lost"])[:kept]
        out["lost"] = out["lost"].copy()
        out["lost"][send] |= lost_kept
    return out


def _streams_for(enc: Dict, feat: np.ndarray, pitch_scale: float):
    """Per-utterance (ind1, ind2, indices, pcodes) 4-tuples from a
    batched encode() output, the indices int32 as JAX's."""
    out = []
    ind1 = enc["ind1"].cpu().numpy()
    ind2 = enc["ind2"].cpu().numpy()
    idx = {k: v.cpu().numpy().astype(np.int32)
           for k, v in enc["indices"].items()}
    for b in range(ind1.shape[0]):
        pcodes = bs.quantize_pitch(feat[b, :, 18:] * pitch_scale)
        out.append((ind1[b], ind2[b],
                    {k: v[b] for k, v in idx.items()}, pcodes))
    return out


def measure_operating_points(params, codebooks: Codebooks, feat,
                             scales: Sequence[float] = (
                                 0.5, 0.75, 1.0, 1.5, 2.25, 3.5),
                             l1: float = 0.09, l2: float = 0.28,
                             normalized: bool = True,
                             preset: str = "full",
                             use_mask: bool = False,
                             mask_scale: float = 1000.0,
                             decimate: int = 1) -> List[Dict]:
    """params: the FramePredictor (its device runs the encoder); feat:
    (B, L, 20) calibration frames (normalised when `normalized`), an
    array or a tensor.  One dict a scale: {preset, scale, l1, l2, bps,
    mse, priors, orders, sizes, decimate}, bps the mean range-coded rate
    over the batch with priors collected from the same batch, mse the
    coded-feature MSE over the 18 cepstral dims.  decimate > 1: only
    (decimate - 1) / decimate of the frames are sent (threshold path
    only); the bits are spread over ALL frames and the MSE includes the
    frames the decoder free-runs through."""
    dev = next(params.parameters()).device
    feat_np = (feat.cpu().numpy() if isinstance(feat, torch.Tensor)
               else np.asarray(feat, np.float32))
    feat_t = torch.as_tensor(feat_np, device=dev)
    pitch_scale = C.MAXI if normalized else 1.0
    sizes = codebook_sizes(codebooks)
    rc = native_rc.best()
    orders = rc.scalar_orders(codebooks)
    # use_mask: the indicators come from the trained mask head, and the
    # threshold scale is inert (callers sweep presets only)
    send = None
    if decimate > 1:
        assert not use_mask, "decimation rides the threshold path"
        send = send_pattern(feat_np.shape[1], decimate)
    points = []
    for s in scales:
        enc = encode(params, codebooks, feat_t, l1=l1 * s, l2=l2 * s,
                     use_mask=use_mask, scale=mask_scale, send=send)
        streams = _streams_for(enc, feat_np, pitch_scale)
        total_frames = sum(len(st[0]) for st in streams)
        if send is not None:
            streams = [decimate_streams(*st, send) for st in streams]
        priors = rc.collect_priors(streams, sizes, orders=orders)
        bits = sum(len(rc.pack_utterance_rc(i1, i2, ix, pc, sizes,
                                            priors=priors, orders=orders))
                   * 8 for i1, i2, ix, pc in streams)
        coded = enc["coded"].cpu().numpy()
        mse = float(np.mean((coded[..., :18] - feat_np[..., :18]) ** 2))
        points.append({"preset": preset, "scale": float(s),
                       "l1": l1 * s, "l2": l2 * s,
                       "bps": bits / total_frames * 100.0, "mse": mse,
                       "priors": priors, "orders": orders,
                       "sizes": sizes, "decimate": decimate})
    return points


def measure_rd_surface(params, codebooks, feat,
                       presets: Dict[str, Dict] = PRESETS,
                       scales: Sequence[float] = (
                           0.35, 0.5, 0.75, 1.0, 1.5, 2.25),
                       l1: float = 0.09, l2: float = 0.28,
                       normalized: bool = True,
                       use_mask: bool = False,
                       mask_scale: float = 1000.0) -> List[Dict]:
    """Sweep presets x threshold scales on a calibration batch.

    Sub-1 scales are included deliberately: once the below-threshold
    VQ is dropped, LOWERING the thresholds routes more frames through
    the fine above-threshold path, so the scale knob spans real rate
    within each reduced preset.  With use_mask the indicator streams
    come from the trained mask head and the scale knob is inert, so
    the sweep collapses to presets only.  Returns the flat point list
    (each point carries its preset name + sizes dict + priors)."""
    if use_mask:
        scales = (1.0,)
        presets = {n: s for n, s in presets.items()
                   if s.get("decimate", 1) == 1}
    points = []
    for name, spec in presets.items():
        cbs = preset_codebooks(codebooks, **spec)
        points.extend(measure_operating_points(
            params, cbs, feat, scales=scales, l1=l1, l2=l2,
            normalized=normalized, preset=name, use_mask=use_mask,
            mask_scale=mask_scale, decimate=spec.get("decimate", 1)))
    return points


def pareto_frontier(points: List[Dict]) -> List[Dict]:
    """Non-dominated subset (no other point has <= bps AND <= mse
    with one strict), sorted by ascending bps."""
    pts = sorted(points, key=lambda p: (p["bps"], p["mse"]))
    out: List[Dict] = []
    best_mse = np.inf
    for p in pts:
        if p["mse"] < best_mse - 1e-12:
            out.append(p)
            best_mse = p["mse"]
    return out


def select_preset(points: List[Dict], target_bps: float) -> Dict:
    """Best-quality frontier point whose measured rate fits within
    target_bps; below the measured range, the lowest-rate point.
    The returned dict is a deployable operating point: preset name,
    thresholds, sizes, and the calibration priors."""
    front = pareto_frontier(points)
    fits = [p for p in front if p["bps"] <= target_bps]
    return fits[-1] if fits else front[0]


def select_scale(points: List[Dict], target_bps: float) -> Dict:
    """Pick/interpolate the threshold scale whose measured rate is
    closest to target_bps (log-linear interpolation on the monotone
    rate-vs-scale curve; clamps at the measured ends).  Returns
    {scale, l1, l2, bps_est} — re-encode at the returned thresholds
    (and collect fresh priors) to deploy the preset."""
    pts = sorted(points, key=lambda p: p["bps"])
    if target_bps <= pts[0]["bps"]:
        p = pts[0]
        return {"scale": p["scale"], "l1": p["l1"], "l2": p["l2"],
                "bps_est": p["bps"]}
    if target_bps >= pts[-1]["bps"]:
        p = pts[-1]
        return {"scale": p["scale"], "l1": p["l1"], "l2": p["l2"],
                "bps_est": p["bps"]}
    for lo, hi in zip(pts, pts[1:]):
        if lo["bps"] <= target_bps <= hi["bps"]:
            t = (np.log(target_bps) - np.log(lo["bps"])) / (
                np.log(hi["bps"]) - np.log(lo["bps"]))
            s = float(np.exp((1 - t) * np.log(lo["scale"])
                             + t * np.log(hi["scale"])))
            ratio = lo["l1"] / lo["scale"], lo["l2"] / lo["scale"]
            return {"scale": s, "l1": ratio[0] * s, "l2": ratio[1] * s,
                    "bps_est": float(target_bps)}
    raise AssertionError("unreachable")
