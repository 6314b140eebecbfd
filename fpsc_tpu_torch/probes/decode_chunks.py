"""The feature decode's replayed chunks against its eager loop, on the
card, by chunk size.

    python -m fpsc_tpu_torch.probes.decode_chunks [--chunks 16,32,64]
                                                  [--reps 5] [--out FILE]

The codec's predictor (384 / 128, its head scaled by 0.05, seeded)
decodes seeded residuals and pitch at the decode cells' shapes: a bulk
call's bucket of 64 utterances of 400 frames, and one natural-length
utterance of 1,200 frames at batch 1.  One line of JSON each:

* `eager`: the wall of `frame_predictor.decoder`'s eager loop under
  `torch.no_grad()`, as a decode ran it before the chunks (`replays`
  patched to refuse), the median of `--reps` calls, each ended by a
  synchronise;
* `chunks`: for each chunk size K (`frame_predictor.DECODE_CHUNK`
  patched), the wall of making a `DecodeChunks` (the warm-up and the
  capture), the median wall of its `run` over the
  same frames, and its frames against the eager loop's (`torch.equal`,
  and the largest difference).

Each line holds the card's name and power limit.  Imports neither JAX
nor the benchmark.  Without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from unittest import mock

import numpy as np
import torch

from fpsc_tpu_torch.models import frame_predictor as fp
from fpsc_tpu_torch.probes.span_cost import where
from fpsc_tpu_torch.utils.device import resolve_device

# (batch, frames): a bulk call's bucket, a natural utterance at batch 1
SHAPES = ((64, 400), (1, 1200))


def predictor(dev) -> fp.FramePredictor:
    model = fp.FramePredictor(fp.FramePredictorConfig(),
                              torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.fc.w.mul_(0.05)
        model.fc.b.mul_(0.05)
    return model.to(dev).requires_grad_(False)


def operands(batch: int, frames: int, dev):
    rng = np.random.RandomState(batch * 10_000 + frames)
    pitch = np.stack([rng.uniform(-1.3, 3.7, (batch, frames)),
                      rng.uniform(-0.5, 0.5, (batch, frames))], -1)
    r = rng.randn(batch, frames, fp.NB_CEPS) * 0.05
    return (torch.as_tensor(pitch.astype(np.float32), device=dev),
            torch.as_tensor(r.astype(np.float32), device=dev))


def wall_ms(fn, reps: int) -> float:
    """The median wall of fn() in ms, each call ended by a synchronise,
    after one call that is not timed."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", default="16,32,64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    at = where(dev)
    model = predictor(dev)
    lines = []

    def emit(kind, **fields):
        line = json.dumps({"kind": kind, **fields, **at})
        lines.append(line)
        print(line, flush=True)

    for batch, frames in SHAPES:
        pitch, r = operands(batch, frames, dev)

        def eager():
            with torch.no_grad(), mock.patch.object(fp, "replays",
                                                    lambda device: False):
                return fp.decoder(model, pitch, r)

        want = eager()[..., :fp.NB_CEPS]
        emit("eager", batch=batch, frames=frames,
             ms=wall_ms(eager, args.reps))
        x = torch.cat([r, pitch], dim=-1)
        for k in map(int, args.chunks.split(",")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(fp, "DECODE_CHUNK", k):
                chunks = fp.DecodeChunks(model, batch, r)
            capture_ms = (time.perf_counter() - t0) * 1e3
            got = chunks.run(model, x)
            emit("chunks", batch=batch, frames=frames, chunk=k,
                 capture_ms=capture_ms,
                 ms=wall_ms(lambda: chunks.run(model, x), args.reps),
                 equal=bool(torch.equal(got, want)),
                 max_diff=float((got - want).abs().max()))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
