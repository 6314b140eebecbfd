"""The live driver: a closed loop of full-duplex ticks over N streams.

Set-up, from the seed: the weights on the card (core/inputs.py), the
speech-sized codebooks, the streams' speech-like PCM (core/speech.py);
the program's `StreamingCodec(from_pcm=True, batch=N)` with those
weights, which captures its tick as one CUDA graph; a warm-up of
`warmup_ticks` ticks on the streams' own blocks, then `reset()`.

The window: tick after tick, each a synchronised `process_pcm` of every
stream's next 10 ms block, with uniforms drawn by the benchmark from the
seed; each tick is a span of the record.  A traced run profiles the
traffic's `traced_ticks` ticks after the first.

After the window: the peak device memory is read, then the traffic's
`judged_streams` streams, drawn from the seed, are judged over their
whole run against the reference (reference/live.py): pitch, symbols,
coded frames and samples.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from benchmark.core import inputs, speech, trace
from benchmark.core.record import Check, Record
from benchmark.drivers.decode import load_weights
from benchmark.reference import dsp, frontend, live

FIELDS = ("ind1", "ind2", "scl", "scl_bl", "vq", "vq_bl")
# A sample is off the grid where its excitation, recovered with the
# reference's LPC, lies more than this share of half a level from the
# nearest mu-law level.  The stream's LPC is not among the program's
# outputs: on a peaky frame Levinson-Durbin turns float32 rounding into
# up to 1e-4 of a coefficient, so the widest distance of a sound run
# swings (0.009-0.124 of half a level over 16 runs) and is not compared.
OFF_GRID = 0.5


def run(rec: Record, seed: int, seconds: float, work: str, limits: Dict,
        t_start: float, log, control: bool = False,
        device: str = "cuda") -> None:
    from fpsc_tpu_torch.codec.streaming import StreamingCodec
    from fpsc_tpu_torch.models import frame_predictor as fp
    from fpsc_tpu_torch.models import lpcnet

    cfg, traffic = rec.config, rec.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    n = traffic["streams"]
    w = inputs.weights(cfg, seed, dev)
    books_np = inputs.codebooks(cfg, seed)
    books = {k: torch.as_tensor(v, device=dev) for k, v in books_np.items()}
    c, p, v = cfg["codec"], cfg["predictor"], cfg["vocoder"]
    gen = torch.Generator().manual_seed(0)
    predictor = fp.FramePredictor(fp.FramePredictorConfig(
        in_features=p["in_features"], gru_units1=p["gru_units1"],
        gru_units2=p["gru_units2"], fc_units=p["out_features"]), gen)
    vocoder = lpcnet.LPCNet(lpcnet.LPCNetConfig(
        gru_a_units=v["gru_a_units"], gru_b_units=v["gru_b_units"],
        embed_dim=v["embed_dim"], cond_units=v["cond_units"]), gen)
    load_weights(predictor, w, unused=("mask_",))
    load_weights(vocoder, w)
    codebooks = fp.Codebooks(
        scl=books["scl"], vq=tuple(books[f"vq_{s}"]
                                   for s in range(len(c["vq"]))),
        scl_bl=books["scl_bl"],
        vq_bl=tuple(books[f"vq_bl_{s}"] for s in range(len(c["vq_bl"]))))
    pcm = speech.streams(inputs.rng(seed, 8), traffic)    # (N, K, 160)
    period = pcm.shape[1]
    codec = StreamingCodec(predictor.to(dev), codebooks, vocoder.to(dev),
                           l1=c["l1"], l2=c["l2"], batch=n, from_pcm=True,
                           device=dev)
    ugen = torch.Generator().manual_seed(int(seed) % 2 ** 63)
    warm = torch.Generator().manual_seed(1)
    for k in range(traffic["warmup_ticks"]):
        codec.process_pcm(pcm[:, k % period], uniforms=torch.rand(
            (dsp.FRAME, n, 1), generator=warm).numpy())
    codec.reset()

    judged = np.sort(inputs.rng(seed, 9).choice(n, traffic["judged_streams"],
                                                replace=False))
    kept: Dict[str, list] = {k: [] for k in FIELDS + ("coded", "audio", "u")}
    n_traced = traffic["traced_ticks"] if rec.traced else 0
    profiles: list = []
    stack = contextlib.ExitStack()
    rec.setup_s = time.perf_counter() - t_start
    t_end = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < t_end:
        if k == 1 and n_traced:
            stack.enter_context(trace.traced(profiles))
        u = torch.rand((dsp.FRAME, n, 1), generator=ugen).numpy()
        rec.attempted += 1
        with rec.span("tick", traced=1 <= k <= n_traced):
            out = codec.process_pcm(pcm[:, k % period], uniforms=u)
        if k == n_traced:
            stack.close()
        for f in ("coded", "audio", "ind1", "ind2"):
            kept[f].append(out[f][judged])
        for f in ("scl", "scl_bl", "vq", "vq_bl"):
            kept[f].append(out["indices"][f][judged])
        kept["u"].append(u[:, judged, 0].T)
        k += 1
    stack.close()
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    rec.traces = [trace.read(prof, work) for prof in profiles]
    rec.add("streams", n)
    del codec
    judge(rec, cfg, w, books, pcm[judged], kept, k, limits, dev, log,
          control)


def judge(rec: Record, cfg: Dict, w, books, pcm: np.ndarray, kept, ticks,
          limits: Dict, dev, log, control: bool) -> None:
    """The checks of the judged streams over all `ticks` ticks."""
    period = pcm.shape[1]
    blocks = torch.as_tensor(pcm[:, np.arange(ticks) % period], device=dev)

    def stack(f, dtype=None):
        return torch.as_tensor(np.stack(kept[f], 1), device=dev,
                               dtype=dtype)

    out = {"coded": stack("coded"), "ind1": stack("ind1", torch.bool),
           "ind2": stack("ind2", torch.bool)}
    for f in ("scl", "scl_bl", "vq", "vq_bl"):
        out[f] = stack(f, torch.long)
    y = stack("audio").reshape(len(pcm), -1)
    u = stack("u")                                     # (B, T, 160)
    c = cfg["codec"]
    feats = frontend.features(blocks)
    got = live.judge_codec(w, books, feats, out, c["l1"], c["l2"])
    margins, _, off_grid = live.judge_audio(w, got["coded"], y, u)
    nums = {"pitch_off_share": float(got["pitch_off"].float().mean()),
            "symbols_off_share": float(got["symbols_off"].float().mean()),
            "coded_err": float(got["coded_err"].max()),
            "draw_off_share": float((margins > 0).float().mean()),
            "off_grid_share": float((off_grid > OFF_GRID).float().mean())}
    log(f"judged {len(pcm)} streams over {ticks} ticks; read and not "
        f"compared: the widest margin of a draw {float(margins.max())!r}, "
        f"the largest off-grid distance {float(off_grid.max())!r}")
    if control:
        low_feats = frontend.features(blocks, tf32=True)
        low = live.judge_codec(w, books, feats, out, c["l1"], c["l2"],
                               prec=live.CONTROL, feats_low=low_feats)
        _, ctl, _ = live.judge_audio(w, got["coded"], y, u,
                                     prec=live.CONTROL)
        rec.lists["control"] = [{
            "pitch_off_share": float(low["pitch_off"].float().mean()),
            "symbols_off_share": float(low["symbols_off"].float().mean()),
            "coded_err": float(low["coded_err"].max()),
            "draw_off_share": float((ctl > 0).float().mean()),
            "draw_margin_max": float(ctl.max())}]
    rec.checks = [Check(k, v, limits[k]) for k, v in nums.items()]
