"""What the port's span recorder costs a live duplex tick, on the card.

    python -m fpsc_tpu_torch.probes.span_cost [--streams 512] [--ticks 300]
                                              [--rounds 4] [--traced 10]
                                              [--out FILE]

A `StreamingCodec(from_pcm=True)` at LPCNet's published widths (GRU_A
384 dense, GRU_B 16, embedding and conditioning 128) behind the codec's
predictor (384 / 128, its head scaled by 0.05) and speech-sized random
books (256 / 16 scalar, (1024, 1024) / (512,) VQ), every weight seeded,
ticks over `--streams` streams of speech-like PCM (data/synthetic.py,
SIGNALS seeded utterances, each stream one of them from its own offset)
with the uniforms drawn outside the tick, as a gateway carrying live
calls would.  One
line of JSON each:

* `recorder`: `--rounds` rounds of `--ticks` ticks with the recorder on,
  then as many with it off (`record_spans(False)`); the median and p95
  tick wall of each, and their difference;
* `spans`: over the ticks with the recorder on, the median of each of
  the tick's spans (stage, launch, wait, unpack), their median sum
  against the median wall, and the ticks split at the midpoint of the
  lowest and highest tenth of the walls: the count and the median wall
  and spans of each side, which says which span holds a difference of
  levels;
* `profiler`: profiles of `--traced` ticks each (CPU and CUDA activity,
  as the benchmark traces them), two with the recorder on and two with
  it off, in turns: the median wall of each kind, and of those with it
  on, the median wall less the median span sum of the untraced ticks,
  the host's cost of profiling a tick; the recorder's annotations cost
  the difference of the two kinds;
* `span`: the recorder's own cost a span on this host, on and off.

Each line holds the card's name and power limit.  Imports neither JAX
nor the benchmark.  Without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fpsc_tpu_torch.codec.streaming import StreamingCodec
from fpsc_tpu_torch.data.synthetic import speech_like_waveform
from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.models.lpcnet import LPCNet, LPCNetConfig
from fpsc_tpu_torch.probes.timing import card
from fpsc_tpu_torch.utils import logging as spans
from fpsc_tpu_torch.utils.device import resolve_device

PARTS = ("tick.stage", "tick.launch", "tick.wait", "tick.unpack")
# distinct utterances, and the 10 ms blocks of each
SIGNALS, BLOCKS = 16, 64


def where(dev) -> dict:
    """The card's name and power limit; a CPU device is refused."""
    name = card(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": name, "smi": smi.stdout.strip()}


def codec(streams: int, dev) -> StreamingCodec:
    g = torch.Generator().manual_seed(0)
    pred = fp.FramePredictor(fp.FramePredictorConfig(), g)
    with torch.no_grad():
        pred.fc.w.mul_(0.05)
        pred.fc.b.mul_(0.05)
    voc = LPCNet(LPCNetConfig(), g)
    rng = np.random.RandomState(0)

    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    books = fp.Codebooks(scl=t(np.sort(rng.randn(256)) * 0.05),
                         vq=tuple(t(rng.randn(1024, 17) * 0.03)
                                  for _ in range(2)),
                         scl_bl=t(np.sort(rng.randn(16)) * 0.02),
                         vq_bl=(t(rng.randn(512, 17) * 0.02),))
    return StreamingCodec(pred.to(dev), books, voc.to(dev), batch=streams,
                          from_pcm=True, device=dev)


class Ticks:
    """Ticks of the codec on speech-like PCM, each wall with its
    program spans."""

    def __init__(self, obj: StreamingCodec, streams: int):
        self.obj, self.streams = obj, streams
        rng = np.random.RandomState(1)
        base = np.stack([speech_like_waveform(rng, BLOCKS * C.FRAME_SIZE)
                         for _ in range(SIGNALS)])
        base = base.reshape(SIGNALS, BLOCKS, C.FRAME_SIZE)
        # (blocks, streams, 160): stream s is utterance s % SIGNALS from
        # block 37 (s // SIGNALS), cyclically
        self.pcm = np.stack([np.roll(base[s % SIGNALS], -37 * (s // SIGNALS),
                                     axis=0) for s in range(streams)], 1)
        self.ugen = torch.Generator().manual_seed(2)
        self.k = 0

    def run(self, n: int) -> list:
        """n ticks -> [(wall s, {span name: s})]."""
        out = []
        for _ in range(n):
            u = torch.rand((160, self.streams, 1), generator=self.ugen).numpy()
            spans.clear_spans()
            t0 = time.perf_counter()
            self.obj.process_pcm(self.pcm[self.k % len(self.pcm)], uniforms=u)
            wall = time.perf_counter() - t0
            parts = {}
            for s in spans.spans():
                parts[s.name] = parts.get(s.name, 0.0) + s.seconds
            out.append((wall, parts))
            self.k += 1
        return out


def ms(x: float) -> float:
    return round(x * 1e3, 4)


def p95(xs) -> float:
    return statistics.quantiles(xs, n=20)[-1]


def summary(ticks: list) -> dict:
    walls = [w for w, _ in ticks]
    out = {"ticks": len(ticks), "wall_ms": ms(statistics.median(walls))}
    for name in PARTS:
        out[name] = ms(statistics.median(p.get(name, 0.0) for _, p in ticks))
    out["sum_ms"] = ms(statistics.median(
        sum(p.get(n, 0.0) for n in PARTS) for _, p in ticks))
    return out


def span_cost(n: int = 100_000) -> dict:
    out = {}
    for on in (True, False, True, False):
        spans.record_spans(on)
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("tick.stage", batch=1):
                pass
        out.setdefault("on" if on else "off", []).append(
            (time.perf_counter() - t0) / n * 1e6)
    spans.record_spans(True)
    spans.clear_spans()
    return {k: round(min(v), 4) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--traced", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    at = where(dev)
    lines = []

    def emit(kind, **fields):
        line = json.dumps({"kind": kind, **fields, **at})
        lines.append(line)
        print(line, flush=True)

    emit("span", us_a_span=span_cost())
    ticks = Ticks(codec(args.streams, dev), args.streams)
    ticks.run(20)                                          # warm-up
    on, off = [], []
    for _ in range(args.rounds):
        spans.record_spans(True)
        on += ticks.run(args.ticks)
        spans.record_spans(False)
        off += ticks.run(args.ticks)
    spans.record_spans(True)
    w_on, w_off = [w for w, _ in on], [w for w, _ in off]
    emit("recorder", streams=args.streams, ticks=len(on),
         on_median_ms=ms(statistics.median(w_on)), on_p95_ms=ms(p95(w_on)),
         off_median_ms=ms(statistics.median(w_off)),
         off_p95_ms=ms(p95(w_off)),
         median_diff_ms=ms(statistics.median(w_on)
                           - statistics.median(w_off)))
    walls = sorted(w_on)
    tenth = max(1, len(walls) // 10)
    cut = (statistics.median(walls[:tenth])
           + statistics.median(walls[-tenth:])) / 2
    low, high = ([t for t in on if t[0] < cut],
                 [t for t in on if t[0] >= cut])
    emit("spans", all=summary(on), cut_ms=ms(cut),
         **({"low": summary(low), "high": summary(high)} if low else {}))
    from torch.profiler import ProfilerActivity, profile
    traced = {True: [], False: []}
    for recording in (True, False, True, False):
        spans.record_spans(recording)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            traced[recording] += ticks.run(args.traced)
    spans.record_spans(True)
    w_off = statistics.median(w for w, _ in traced[False])
    emit("profiler", traced=summary(traced[True]),
         traced_off_wall_ms=ms(w_off),
         host_cost_ms=ms(summary(traced[True])["wall_ms"] / 1e3
                         - summary(on)["sum_ms"] / 1e3))
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
