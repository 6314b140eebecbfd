"""The WaveNet's generation over buckets of several batch sizes, on the
card: what a change of bucket size costs.

    python -m fpsc_tpu_torch.probes.wavenet_buckets [--batches 64,32,16]
                                                    [--frames 100]
                                                    [--passes 2] [--out FILE]

A seeded WaveNet at the published widths (final2's gains scaled by
0.05) generates `--frames` frames of seeded operands for each batch of
`--batches` in turn, `--passes` times, through `wavenet.generate`, as
decode_file voices the buckets of a container of several sizes.  One
line of JSON a bucket: its wall (the card synchronised), the captures
it made (`wavenet.capture` spans) and their wall, and the rows its
chunks ran; one line a pass: its wall, its peak device memory, and the
memory held after it.  Each line holds the card's name and power limit.
Imports neither JAX nor the benchmark.  Without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.probes.span_cost import where
from fpsc_tpu_torch.utils import logging as log
from fpsc_tpu_torch.utils.device import resolve_device


def wavenet(dev) -> wn.Wavenet:
    model = wn.Wavenet(wn.WavenetConfig(), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.final2.g.mul_(0.05)
    return model.to(dev).requires_grad_(False)


def operands(model: wn.Wavenet, batch: int, frames: int, dev):
    """step_inputs' conditioning and LPC, and the eps, of seeded frames."""
    g = torch.Generator().manual_seed(batch)
    feat = torch.randn((batch, 20, frames), generator=g) * 0.3
    periods = torch.randint(32, 256, (batch, frames), generator=g)
    lpc = torch.randn((batch, frames, 16), generator=g) * 0.04
    eps = torch.randn((frames * C.FRAME_SIZE, batch), generator=g)
    cond, lpc_rev = wn.step_inputs(model, model.cfg, feat.to(dev),
                                   periods.to(dev),
                                   wn.sample_lpc(lpc.to(dev)))
    return cond, lpc_rev, eps.to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="64,32,16")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    at = where(dev)
    model = wavenet(dev)
    batches = [int(b) for b in args.batches.split(",")]
    ops = {b: operands(model, b, args.frames, dev) for b in batches}
    lines = []

    def emit(kind, **fields):
        line = json.dumps({"kind": kind, **fields, **at})
        lines.append(line)
        print(line, flush=True)

    for p in range(args.passes):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t_pass = time.perf_counter()
        for b in batches:
            log.clear_spans()
            t0 = time.perf_counter()
            wn.generate(model, *ops[b])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            caps = [s for s in log.spans() if s.name == "wavenet.capture"]
            gen = [s for s in log.spans() if s.name == "wavenet.generate"]
            emit("bucket", pass_=p, batch=b, frames=args.frames, wall_s=wall,
                 captures=len(caps),
                 capture_s=sum(s.seconds for s in caps),
                 rows=gen[0].attrs.get("rows", b),
                 graph=gen[0].attrs["graph"])
        torch.cuda.synchronize()
        emit("pass", pass_=p, batches=batches,
             wall_s=time.perf_counter() - t_pass,
             peak_bytes=torch.cuda.max_memory_allocated(dev),
             held_bytes=torch.cuda.memory_allocated(dev))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
