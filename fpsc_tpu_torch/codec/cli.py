"""File codec CLI of the port: wav -> `.fpsc` -> wav, on the card.

    # encode: wav in, one .fpsc out
    python -m fpsc_tpu_torch.codec.cli encode OUT.fpsc IN.wav [IN2.wav ...] \
        train.transfer_model=<label> codec.codebook_path=cb.npz \
        [codec.preset=lean] [codec.use_mask=true] [key=value ...] \
        [--device=cpu]

    # decode: .fpsc in, wavs out
    python -m fpsc_tpu_torch.codec.cli decode IN.fpsc OUT_DIR \
        train.transfer_model=<label> codec.codebook_path=cb.npz \
        train.vocoder_model=<label_s> [codec.vocoder=wavenet] \
        [key=value ...] [--device=cpu]

Port of fpsc_tpu/codec/cli.py.  Encode (`encode_paths`, cli.py:120-253):
read the wavs (mono, 16 kHz, resampled otherwise) -> the batched
analysis frontend (dsp/frontend.py) -> the closed-loop encoder with
in-loop m-best VQ (codec/codec.py::encode), conditioned on the
dequantised pitch, threshold or learned-mask path -> in-band FEC
requantisation when asked (codec/plc.py::fec_requantize) -> the coders
-> one container; it writes the bytes JAX's encoder writes.  Decode
(`decode_file`, cli.py:256-415): unpack the symbols -> closed-loop
feature decode -> ceps2lpc -> the vocoder of one of two families
(`codec.vocoder`): `lpcnet`, the default, a frame-rate prologue then the
CUDA LPCNet sampler, bunch=1, 2 or 4 (lpcnet.bunch=2 with for example
lpcnet.gru_b_units=32; lpcnet.bunch=4 with lpcnet.gru_b_units=64),
dense or with GRU_A's block-sparse product where the checkpoint's
recurrent weights are block-sparse; or `wavenet`, the WaveNet-with-LPC
vocoder that train/train_all.py trains on the predictor's coded
features (at `wavenet.*`'s widths; its checkpoint `<label>_s`): the
upsampler, then generation replayed as captured chunks of sample steps
on the card (models/wavenet.py::generate).  Both sides bucket utterances
by frame count and run each bucket as one batch; a decode bucket of more
than 128 utterances takes the sampler's cdf_matmul form, as the JAX
decoder does.

Every container the JAX CLI writes decodes, and the encoder writes each
of them: fixed-layout or range-coded (the default; the range coder is
the native C++ runtime of codec/native_rc.py, which g++ builds into
build/host/ at first use; where it does not build, the decoder falls
back to the Python coder and the encoder fails); whole utterances or
packets of `codec.packet_ms` (codec/range_coder.py's packet paths), with
or without in-band FEC (`codec.fec=true`); and every rate preset of
codec/rate_control.py (`codec.preset=lean` etc. reduces the codebooks
before the geometry is derived or checked).  On a packetized stream
`codec.sim_drop=0.1 codec.sim_seed=0` simulates an iid channel that
drops 10% of the packets (never the first): lost spans recover from
the next packet's redundancy (FEC) or are concealed by the closed-loop
predictor (codec/plc.py), and the decoder prints each utterance's
recovery report.
"""
from __future__ import annotations

import os
import sys
import time
import wave
from itertools import islice
from math import gcd
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fpsc_tpu_torch.codec import bitstream as bs
from fpsc_tpu_torch.codec import container, native_rc, plc, rate_control
from fpsc_tpu_torch.codec import range_coder as rc
from fpsc_tpu_torch.codec.codec import decode, encode
from fpsc_tpu_torch.config.config import Config, apply_overrides
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.dsp.ceps2lpc import ceps2lpc
from fpsc_tpu_torch.dsp.frontend import extract_features_batch
from fpsc_tpu_torch.eval.stoi import resample_poly
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.models.frame_predictor import codebook_sizes
from fpsc_tpu_torch.models.lpcnet import LPCNetConfig
from fpsc_tpu_torch.models.lpcnet_bunched import VOCODERS
from fpsc_tpu_torch.ops import lpcnet_sampler
from fpsc_tpu_torch.train import checkpoint as ckpt
from fpsc_tpu_torch.train.train_frame import load_predictor
from fpsc_tpu_torch.train.train_vocoder import model_config
from fpsc_tpu_torch.utils.device import (resolve_device, side_streams,
                                         split_device_arg)
from fpsc_tpu_torch.utils.logging import span

# (frames, batch) -> (frames, batch, 160) uniforms in [0, 1)
UniformSource = Callable[[int, int], np.ndarray]


def load_artifacts(cfg: Config, need_vocoder: bool = False, device=None):
    """[predictor, codebooks, sizes, priors, orders, rcmod(, vocoder)]
    from the checkpoint and codebook paths in cfg.  The rate preset
    (cfg.codec.preset) is applied to the codebooks here, so that sizes,
    the value ranks of the scalar books (orders) and every later layer
    see the reduced geometry; the entropy-model priors stored beside the
    codebooks (None when there are none) lose the stages the preset
    drops.  rcmod is native_rc.best(), the range coder that decodes.
    Weights are seeded random where cfg names no checkpoint."""
    dev = resolve_device(device)
    preset = cfg.codec.preset
    if preset not in rate_control.PRESETS:
        raise ValueError(f"unknown rate preset {preset!r}: one of "
                         f"{sorted(rate_control.PRESETS)}")
    predictor = load_predictor(cfg, dev)
    codebooks = ckpt.load_codebooks(cfg.codec.codebook_path, dev)
    if preset != "full":
        codebooks = rate_control.preset_codebooks(
            codebooks, **rate_control.PRESETS[preset])
    sizes = codebook_sizes(codebooks)
    priors = ckpt.load_priors(cfg.codec.codebook_path)
    if priors is not None and preset != "full":
        # priors are collected at the full geometry; a preset drops
        # vector stages, whose priors go (fpsc_tpu/codec/cli.py:80-88)
        dropped = {f"vq_{s}" for s in range(len(sizes["vq"]), 9)}
        dropped |= {f"vq_bl_{s}" for s in range(len(sizes["vq_bl"]), 9)}
        priors = {k: v for k, v in priors.items() if k not in dropped}
    rcmod = native_rc.best()
    out = [predictor, codebooks, sizes, priors,
           rcmod.scalar_orders(codebooks), rcmod]
    if need_vocoder:
        out.append(load_vocoder(cfg, dev))
    return out


def load_vocoder(cfg: Config, device):
    """The vocoder of cfg.codec.vocoder's family: for `lpcnet`, LPCNet
    for lpcnet.bunch=1, BunchedLPCNet for 2, Bunched4LPCNet for 4; for
    `wavenet`, the WaveNet-with-LPC vocoder at cfg.wavenet's widths.
    Seeded random, or restored from train.vocoder_model."""
    family = cfg.codec.vocoder
    gen = torch.Generator().manual_seed(cfg.train.seed + 2)
    if family == "wavenet":
        vocoder, what = wn.Wavenet(model_config(cfg), gen), "WaveNet vocoder"
    elif family == "lpcnet":
        bunch = cfg.lpcnet.bunch
        if bunch not in VOCODERS:
            raise ValueError(
                f"lpcnet.bunch={bunch}: the sampler runs bunch=1, bunch=2 "
                "and bunch=4 LPCNets only (codec.vocoder=wavenet decodes "
                "with the WaveNet-with-LPC vocoder instead)")
        lcfg = LPCNetConfig(
            gru_a_units=cfg.lpcnet.gru_a_units,
            gru_b_units=cfg.lpcnet.gru_b_units,
            embed_dim=cfg.lpcnet.embed_dim,
            cond_units=cfg.lpcnet.cond_units)
        vocoder, what = VOCODERS[bunch](lcfg, gen), f"vocoder (bunch={bunch})"
    else:
        raise ValueError(f"codec.vocoder={family!r}: the decoder's vocoder "
                         "families are lpcnet, wavenet")
    if cfg.train.vocoder_model:
        payload = ckpt.load(ckpt.checkpoint_path(
            cfg.train.save_dir, cfg.train.vocoder_model,
            cfg.train.vocoder_epoch))
        ckpt.restore(vocoder, payload, what)
    return vocoder.to(device)


def save_wav(path: str, x: np.ndarray, sr: int = C.SAMPLE_RATE) -> None:
    """Peak-normalised 16-bit PCM mono wav (fpsc_tpu/train/synthesis.py:30)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = np.asarray(x, np.float64)
    x = x / max(np.abs(x).max(), 1e-9)
    pcm = (x * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


class _Phases:
    """The spans of an encode or a decode (utils/logging.py): a root span
    `<kind>` over the call and under it `<kind>.<name>` for each phase,
    each beginning where the one before ends.  With a dict to fill (the
    caller's `timings=`), each boundary first synchronises the device,
    and each phase's wall seconds are added under its name."""

    def __init__(self, kind: str, out: Optional[Dict[str, float]], device):
        self.kind, self.out, self.device = kind, out, device
        self.root = span(kind)
        self.open: Optional[span] = None

    def __enter__(self) -> "_Phases":
        self.root.__enter__()
        return self

    def __exit__(self, failed, *exc) -> None:
        if failed is None:
            self.end()
        elif self.open is not None:
            self.open.end(time.perf_counter_ns())
        self.root.__exit__()

    def begin(self, name: str, **attrs) -> None:
        """End the phase that is open and begin `name`."""
        now = self._boundary()
        self.open = span(f"{self.kind}.{name}", **attrs)
        self.open.begin(now)

    def note(self, **attrs) -> None:
        """Attributes of the phase that is open."""
        self.open.attrs.update(attrs)

    def end(self) -> None:
        """End the phase that is open, if any."""
        self._boundary()
        self.open = None

    def _boundary(self) -> int:
        """The clock reading at which the phase that is open ends."""
        if self.open is None:
            return time.perf_counter_ns()
        if self.out is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter_ns()
        self.open.end(now)
        if self.out is not None:
            name = self.open.name[len(self.kind) + 1:]
            self.out[name] = self.out.get(name, 0.0) + self.open.seconds
        return now


def read_wav(path: str) -> np.ndarray:
    """16 kHz mono float32 waveform: the channels' mean, int16 divided by
    32768, other rates resampled (eval/stoi.py::resample_poly)."""
    from scipy.io import wavfile
    sr, x = wavfile.read(path)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    x = np.asarray(x, np.float32)
    if sr != C.SAMPLE_RATE:
        g = gcd(C.SAMPLE_RATE, int(sr))
        x = resample_poly(x, C.SAMPLE_RATE // g,
                          int(sr) // g).astype(np.float32)
    return x


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


@torch.no_grad()
def encode_paths(cfg: Config, wav_paths: Sequence[str], out_path: str,
                 artifacts=None, device=None,
                 timings: Optional[Dict[str, float]] = None) -> dict:
    """Encode wav files into one .fpsc container at out_path -> {rates
    (b/s per utterance), bytes (the container's), sizes}.  `artifacts`
    is what load_artifacts(cfg) returns.  Utterances are bucketed by
    frame count and each bucket is encoded as one batch; the closed loop
    is conditioned on the dequantised pitch, what the decoder
    reconstructs, so that the two loops track bit for bit.  Runs on the
    card unless device="cpu".  The phases (read, analysis, encode, fec,
    pack and write) are spans `encode.<phase>` under a span `encode`;
    `timings`, when given, collects their wall seconds, the device
    synchronised at each boundary.
    """
    dev = resolve_device(device)
    with _Phases("encode", timings, dev) as phases:
        return _encode_paths(cfg, wav_paths, out_path, artifacts, dev,
                             phases)


def _encode_paths(cfg: Config, wav_paths: Sequence[str], out_path: str,
                  artifacts, dev, phases: _Phases) -> dict:
    phases.begin("read")
    if artifacts is None:
        artifacts = load_artifacts(cfg, device=dev)
    predictor, codebooks, sizes, priors, orders, _ = artifacts
    scale = C.MAXI if cfg.data.normalize else 1.0

    names = [_stem(p) for p in wav_paths]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(
            "duplicate wav basenames would silently collide in the "
            f"container: {dupes} — rename the inputs")
    waves = [read_wav(p) for p in wav_paths]
    phases.begin("analysis")
    all_rows = extract_features_batch(waves, device=dev)
    phases.begin("encode" if waves else "pack")
    feats, buckets = {}, {}
    for path, name, rows in zip(wav_paths, names, all_rows):
        if rows.shape[0] == 0:
            raise ValueError(f"{path}: too short to code (<2 frames)")
        pitch_dq = bs.dequantize_pitch(bs.quantize_pitch(rows[:, 18:20]))
        feats[name] = np.concatenate([rows[:, :18], pitch_dq], axis=1)
        buckets.setdefault(rows.shape[0], []).append(name)

    packet_frames = cfg.codec.packet_ms // 10
    if cfg.codec.packet_ms and not cfg.codec.entropy_coding:
        raise ValueError("codec.packet_ms requires entropy_coding")
    if cfg.codec.fec and not packet_frames:
        raise ValueError("codec.fec requires codec.packet_ms > 0")
    fec_books = fec_sizes = None
    if cfg.codec.fec:
        fec_books = rate_control.preset_codebooks(
            codebooks, **rate_control.PRESETS["lean"])
        fec_sizes = codebook_sizes(fec_books)

    coded = {}
    for i, names_b in enumerate(buckets.values()):
        feat = torch.as_tensor(np.stack([feats[n] for n in names_b]) / scale,
                               device=dev)
        enc = encode(predictor, codebooks, feat, l1=cfg.codec.l1,
                     l2=cfg.codec.l2, use_mask=cfg.codec.use_mask,
                     scale=cfg.codec.mask_scale)
        phases.begin("fec")
        fidx = (plc.fec_requantize(fec_books, enc["r"], enc["ind1"],
                                   enc["ind2"]) if cfg.codec.fec else None)
        # this bucket's copies to the host count to the phase after
        phases.begin("encode" if i + 1 < len(buckets) else "pack")

        def host(d):
            return None if d is None else {k: v.cpu().numpy()
                                           for k, v in d.items()}

        ind1, ind2 = enc["ind1"].cpu().numpy(), enc["ind2"].cpu().numpy()
        idx, fidx = host(enc["indices"]), host(fidx)
        for i, name in enumerate(names_b):
            coded[name] = (ind1[i], ind2[i], {k: v[i] for k, v in idx.items()},
                           None if fidx is None else
                           {k: v[i] for k, v in fidx.items()})

    if cfg.codec.entropy_coding:
        native_rc.load()              # the native coder, or fail
    utts, rates = [], {}
    for name in names:                # the command line's order
        ind1, ind2, idx, fidx = coded[name]
        pitch_raw = feats[name][:, 18:20]
        if cfg.codec.fec:
            payload = rc.pack_packets_fec(
                ind1, ind2, idx, bs.quantize_pitch(pitch_raw), sizes, fidx,
                fec_sizes, packet_frames=packet_frames, priors=priors,
                orders=orders)
            nbytes = sum(len(p) for p in payload)
        elif packet_frames:
            payload = rc.pack_packets(
                ind1, ind2, idx, bs.quantize_pitch(pitch_raw), sizes,
                packet_frames=packet_frames, priors=priors, orders=orders)
            nbytes = sum(len(p) for p in payload)
        elif cfg.codec.entropy_coding:
            payload = native_rc.pack_utterance_rc(
                ind1, ind2, idx, bs.quantize_pitch(pitch_raw), sizes,
                priors=priors, orders=orders)
            nbytes = len(payload)
        else:
            payload = bs.pack_utterance(ind1, ind2, idx, pitch_raw, sizes)
            nbytes = len(payload)
        utts.append((name, payload))
        rates[name] = bs.bitrate_bps(nbytes, feats[name].shape[0])
    phases.begin("write")
    total = container.write_fpsc(
        out_path, utts, sizes, entropy=cfg.codec.entropy_coding,
        use_mask=cfg.codec.use_mask, l1=cfg.codec.l1, l2=cfg.codec.l2,
        mask_scale=cfg.codec.mask_scale, preset=cfg.codec.preset,
        sample_rate=C.SAMPLE_RATE, packet_frames=packet_frames,
        fec=cfg.codec.fec,
        frame_counts={n: f.shape[0] for n, f in feats.items()})
    phases.end()
    for name, bps in rates.items():
        print(f"{name}: {bps:.0f} b/s")
    print(f"wrote {out_path}: {len(utts)} utterance(s), {total} bytes")
    return {"rates": rates, "bytes": total, "sizes": sizes}


@torch.no_grad()
def decode_file(cfg: Config, in_path: str, out_dir: str,
                artifacts=None, vocoder=None,
                device=None, uniforms: Optional[UniformSource] = None,
                timings: Optional[Dict[str, float]] = None) -> List[dict]:
    """Decode every utterance of a .fpsc container to
    out_dir/<name>.wav; returns [{name, coded, lpc, wav}] in container
    order.  `artifacts` and `vocoder` are what
    load_artifacts(cfg, need_vocoder=True) returns.

    A packetized container decodes packet by packet; with
    cfg.codec.sim_drop > 0 its packets are dropped first, by one
    RandomState(cfg.codec.sim_seed) drawn per utterance in container
    order, the first packet always kept; lost frames are recovered from
    FEC where the container has it, and concealed otherwise.

    Runs on the card unless device="cpu".  Each bucket's uniforms come
    from a torch.Generator seeded with 0 (the JAX decoder uses
    PRNGKey(0) per bucket), or from `uniforms(frames, batch)`.  The
    sampler works in bf16 on the card and in f32 on the CPU, as the
    JAX decoder's Pallas and XLA samplers do.

    With cfg.codec.vocoder=wavenet each bucket is voiced by the WaveNet:
    its coded features and periods as train/train_all.py feeds them,
    each frame's LPC held over its samples, the upsampler, then
    `wavenet.generate` in float32 with TF32 off.  Its eps (samples,
    batch) come from `torch.randn` of a torch.Generator on the device
    seeded with 0 a bucket, so that a caller can draw them again.

    The buckets of the LPCNet run in groups whose rows fit one wave of
    the card's SMs (a wider bucket alone): each bucket of a group is
    prepared in turn, then the group's sampler launches go out together,
    each on its own CUDA stream, and are waited on once.  The WaveNet's
    buckets run one after another.

    The phases (unpack; then for each group, for each of its buckets
    feature_decode, ceps2lpc and prologue, then one sampler [launches:
    the group's sampler launches, made before its one wait]; or for each
    WaveNet bucket feature_decode, ceps2lpc, prologue and wavenet; then
    write) are spans `decode.<phase>` under a span `decode`; `timings`,
    when given, collects their wall seconds, the device synchronised at
    each boundary.
    """
    dev = resolve_device(device)
    with _Phases("decode", timings, dev) as phases:
        return _decode_file(cfg, in_path, out_dir, artifacts, vocoder, dev,
                            uniforms, phases)


def _decode_file(cfg: Config, in_path: str, out_dir: str, artifacts,
                 vocoder, dev, uniforms: Optional[UniformSource],
                 phases: _Phases) -> List[dict]:
    sampler_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    phases.begin("unpack")
    if artifacts is None:
        *artifacts, vocoder = load_artifacts(cfg, need_vocoder=True,
                                             device=dev)
    predictor, codebooks, sizes, priors, orders, rcmod = artifacts
    box = container.read_fpsc(in_path)
    meta = box["meta"]
    container.check_geometry(meta, sizes)
    scale = C.MAXI if cfg.data.normalize else 1.0
    os.makedirs(out_dir, exist_ok=True)

    pf, fec = meta["packet_frames"], meta["fec"]
    fec_books = fec_sizes = None
    if fec:
        # the redundancy is coded at the lean preset of the (already
        # reduced) books, with the primary priors and orders
        fec_books = rate_control.preset_codebooks(
            codebooks, **rate_control.PRESETS["lean"])
        fec_sizes = codebook_sizes(fec_books)
    drop_rng = np.random.RandomState(cfg.codec.sim_seed)

    unpacked, buckets, order = {}, {}, []
    for name, payload in box["utterances"]:
        if pf:
            nbytes = sum(len(p) for p in payload)
            total_frames = meta["frame_counts"].get(name)
            if cfg.codec.sim_drop > 0:
                keep = drop_rng.rand(len(payload)) >= cfg.codec.sim_drop
                keep[0] = True          # session start always arrives
                payload = [p if keep[j] else None
                           for j, p in enumerate(payload)]
            if fec:
                got = rc.unpack_packets_fec(
                    payload, sizes, fec_sizes, packet_frames=pf,
                    total_frames=total_frames, priors=priors,
                    orders=orders)
            else:
                got = rc.unpack_packets(payload, sizes, packet_frames=pf,
                                        total_frames=total_frames,
                                        priors=priors, orders=orders)
            if got["lost"].any() or got.get(
                    "from_fec", np.zeros(1, bool)).any():
                print(f"{name}: {int(got['lost'].sum())} frame(s) "
                      f"concealed"
                      + (f", {int(got['from_fec'].sum())} recovered "
                         "from FEC" if fec else ""))
        elif meta["entropy"]:
            got = rcmod.unpack_utterance_rc(payload, sizes, priors=priors,
                                            orders=orders)
            nbytes = len(payload)
        else:
            got = bs.unpack_utterance(payload, sizes)
            nbytes = len(payload)
        unpacked[name] = (got, nbytes)
        buckets.setdefault(len(got["ind1"]), []).append(name)
        order.append(name)
    phases.note(bytes=sum(n for _, n in unpacked.values()),
                utterances=len(order))
    phases.root.attrs.update(utterances=len(order), buckets=len(buckets))
    phases.begin("feature_decode" if buckets else "write")

    def features(n_frames: int, names: List[str]):
        """The bucket's coded features (phase feature_decode), then its
        raw-scale features, periods and LPC (phase ceps2lpc)."""
        phases.note(batch=len(names), frames=n_frames)

        def stack(f):
            return torch.as_tensor(
                np.stack([f(unpacked[n][0]) for n in names]), device=dev)

        g0 = unpacked[names[0]][0]
        # normalised on the host, as the encoder's conditioning is: a
        # division on the card may round otherwise
        pitch = stack(lambda g: g["pitch"] / scale)
        if pf and fec:
            merged = [plc.fec_merge_residual(codebooks, fec_books,
                                             unpacked[n][0]) for n in names]
            coded = plc.conceal_decode_residual(
                predictor, torch.cat([m[0] for m in merged]), pitch,
                torch.cat([m[2] for m in merged]))
        else:
            symbols = (stack(lambda g: g["ind1"]), stack(lambda g: g["ind2"]),
                       {k: stack(lambda g, k=k: g["indices"][k]).long()
                        for k in g0["indices"]}, pitch)
            coded = (plc.conceal_decode(predictor, codebooks, *symbols,
                                        stack(lambda g: g["lost"]))
                     if pf else decode(predictor, codebooks, *symbols))
        phases.begin("ceps2lpc")
        coded_un = coded * scale
        periods = (0.1 + 50.0 * coded_un[..., 18] + 100.0).to(torch.int32)
        _, lpc, _ = ceps2lpc(coded_un.reshape(-1, 20)[:, :18])
        return coded, coded_un, periods, lpc.reshape(coded_un.shape[0], -1, 16)

    out = {}

    def keep(names: List[str], coded, lpc, y) -> None:
        coded, lpc, y = (x.cpu().numpy() for x in (coded, lpc, y))
        for i, name in enumerate(names):
            out[name] = {"name": name, "coded": coded[i], "lpc": lpc[i],
                         "wav": y[i]}

    if cfg.codec.vocoder == "wavenet":
        # every bucket replays the WaveNet's one graph on its static
        # buffers (wavenet.GenerateChunks): one bucket after another
        for b, (n_frames, names) in enumerate(buckets.items()):
            coded, _, periods, lpc = features(n_frames, names)
            phases.begin("prologue")
            y = _synthesize_wavenet(vocoder, coded, periods, lpc, phases)
            # this bucket's copies to the host count to the phase after
            phases.begin("feature_decode" if b + 1 < len(buckets)
                         else "write")
            keep(names, coded, lpc, y)
    else:
        items = iter(buckets.items())
        groups = _groups([len(names) for names in buckets.values()],
                         _wave(dev))
        for g, size in enumerate(groups):
            held = []       # alive until the group's launches are waited on
            for i, (n_frames, names) in enumerate(islice(items, size)):
                if i:
                    phases.begin("feature_decode")
                coded, coded_un, periods, lpc = features(n_frames, names)
                phases.begin("prologue")
                held.append((names, coded, lpc, _prologue(
                    vocoder, coded, periods, lpc, coded_un[..., 19],
                    uniforms, sampler_dtype)))
            phases.begin("sampler", launches=size)
            ys = _sample_together([p for *_, p in held], dev)
            # the group's copies to the host count to the phase after
            phases.begin("feature_decode" if g + 1 < len(groups) else "write")
            for (names, coded, lpc, _), y in zip(held, ys):
                keep(names, coded, lpc, y)

    results = []
    for name in order:
        r = out[name]
        wav_path = os.path.join(out_dir, f"{name}.wav")
        save_wav(wav_path, r["wav"])
        print(f"{name}: {unpacked[name][1]} bytes -> "
              f"{len(r['wav'])} samples -> {wav_path}")
        results.append(r)
    phases.end()
    return results


def _prologue(vocoder, coded, periods, lpc, corr,
              uniforms: Optional[UniformSource], dtype: torch.dtype):
    """The sampler's operands and meta for a bucket: its uniforms (from
    a torch.Generator on the device seeded with 0, or `uniforms`), then
    lpcnet_sampler.prepare on the NORMALISED coded features, with the
    raw-scale correlation, unclipped.  A vocoder whose GRU_A recurrent
    weights are block-sparse runs the kernel's sparse form
    (auto_block_pattern), and a bucket of more than 128 utterances its
    cdf product (prepare's default), as the JAX decoder does."""
    batch, n_frames, _ = coded.shape
    dev = coded.device
    if uniforms is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.rand((n_frames, batch, C.FRAME_SIZE), generator=gen,
                       device=dev)
    else:
        u = torch.as_tensor(np.asarray(uniforms(n_frames, batch)),
                            dtype=torch.float32, device=dev)
    return lpcnet_sampler.prepare(
        vocoder, coded, periods, lpc, u, corr=corr, dtype=dtype,
        gru_a_pattern=lpcnet_sampler.auto_block_pattern(vocoder))


def _wave(dev: torch.device) -> float:
    """The rows a group of buckets may hold: one wave of the card's SMs
    (the sampler kernel runs one thread block a row); on the CPU, whose
    plain sampler runs one bucket after another, no bound."""
    if dev.type != "cuda":
        return float("inf")
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _groups(rows: Sequence[int], limit: float) -> List[int]:
    """The sizes of the consecutive groups that buckets of these row
    counts form, in turn: a group takes the next bucket while their rows
    fit `limit`; a bucket wider than that is a group of its own."""
    sizes, held = [], 0
    for r in rows:
        if not sizes or held + r > limit:
            sizes.append(0)
            held = 0
        sizes[-1] += 1
        held += r
    return sizes


def _sample_together(prepared, dev: torch.device) -> List[torch.Tensor]:
    """The sampler of every (operands, meta) of `prepared` -> each one's
    (B, L*160) audio.  On the card the launches go out together, each on
    its own stream of the device's pool (utils/device.py::side_streams)
    after the work that made its operands, and the current stream then
    waits for all of them; the caller holds the operands until that
    wait, so that none returns to the allocator while a launch still
    reads it.  On the CPU the plain sampler runs them one after
    another.  The audio is each launch's own, as one launch at a time
    gives it."""
    if dev.type != "cuda":
        return [lpcnet_sampler.sample(ops, meta) for ops, meta in prepared]
    cur = torch.cuda.current_stream(dev)
    streams = side_streams(dev, len(prepared))
    ys = []
    for s, (ops, meta) in zip(streams, prepared):
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            ys.append(lpcnet_sampler.sample(ops, meta))
    for s in streams:
        cur.wait_stream(s)
    return ys


def _synthesize_wavenet(vocoder: wn.Wavenet, coded, periods, lpc,
                        phases: _Phases) -> torch.Tensor:
    """The WaveNet-with-LPC vocoder on the NORMALISED coded features
    (B, L, 20) and the periods, as train/train_all.py trains it: each
    frame's LPC held over its samples, the eps drawn, the upsampler and
    the shifted conditioning (phase prologue), then generation (phase
    wavenet) -> (B, L * 160) de-emphasised audio."""
    dev = coded.device
    b, length, _ = coded.shape
    samples = length * C.FRAME_SIZE
    gen = torch.Generator(device=dev).manual_seed(0)
    e = torch.randn((samples, b), generator=gen, device=dev)
    cond, lpc_rev = wn.step_inputs(vocoder, vocoder.cfg,
                                   coded.transpose(1, 2), periods,
                                   wn.sample_lpc(lpc))
    phases.begin("wavenet")
    return wn.generate(vocoder, cond, lpc_rev, e)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("encode", "decode"):
        print(__doc__)
        return 2
    rest, device = split_device_arg(argv[1:])
    cmd = argv[0]
    paths = [a for a in rest if "=" not in a]
    cfg = apply_overrides(Config(), [a for a in rest if "=" in a])
    if cmd == "encode":
        if len(paths) < 2:
            print("encode OUT.fpsc IN.wav [IN2.wav ...] [key=value] "
                  "[--device=cpu]")
            return 2
        encode_paths(cfg, paths[1:], paths[0], device=device)
    else:
        if len(paths) != 2:
            print("decode IN.fpsc OUT_DIR [key=value] [--device=cpu]")
            return 2
        decode_file(cfg, paths[0], paths[1], device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
