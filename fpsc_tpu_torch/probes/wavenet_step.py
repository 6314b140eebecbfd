"""The WaveNet step kernel against the plain chunk, on the card.

    python -m fpsc_tpu_torch.probes.wavenet_step [--rows 1,8,64]
                                                 [--reps 9] [--out FILE]

At each number of rows, a GenerateChunks at the published widths
(final2's gains scaled by 0.05) whose state a few plain chunks carried
on from zero on seeded operands (`carried`); from that state one chunk
of the kernel (ops/wavenet_step.py) and one of the plain version
(`GenerateChunks._plain_chunk`), compared (`compare`); then the time of
a chunk of 128 steps with CUDA events (probes/timing.py): the kernel's
launch as generation replays it (a captured graph of the kernel and the
position's add), and the plain chunk replayed from a captured graph, as
generation ran it before the kernel.  One line of JSON a number of rows:
microseconds a step, the kernel's bound (`least_step_us`: its
multiply-adds at the float32 peak, or its weights read once, the larger)
and the whole step's (the conditioning's projection, which runs outside
the kernel, included, as the benchmark counts it), the largest
differences, the card's name and power limit.  Without a card it
raises.  Imports neither JAX nor the benchmark.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.models import wavenet as wn
from fpsc_tpu_torch.ops import wavenet_step
from fpsc_tpu_torch.probes import timing
from fpsc_tpu_torch.probes.span_cost import where
from fpsc_tpu_torch.utils.device import capture_stream, no_tf32, \
    resolve_device

# The card's published float32 rate and HBM bandwidth (an H100 SXM)
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
STATE = ("rings", "x", "y", "pos")


def wavenet(device, seed: int = 0,
            cfg: wn.WavenetConfig = wn.WavenetConfig()) -> wn.Wavenet:
    model = wn.Wavenet(cfg, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.final2.g.mul_(0.05)
    return model.to(device).requires_grad_(False)


def carried(model: wn.Wavenet, rows: int, device, seed: int = 0,
            warm: int = 3) -> wn.GenerateChunks:
    """A GenerateChunks of `rows` rows, not captured, whose conditioning
    block is projected from seeded frames and whose state `warm` plain
    chunks carried on from zero; the next chunk's eps and LPC seeded."""
    g = torch.Generator().manual_seed(seed)
    frames = -(-wn.WAVENET_CHUNK * (warm + 1) // C.FRAME_SIZE)
    feat = torch.randn((rows, 20, frames), generator=g) * 0.3
    periods = torch.randint(32, 256, (rows, frames), generator=g)
    lpc = torch.randn((rows, frames, 16), generator=g) * 0.04
    eps = torch.randn((frames * C.FRAME_SIZE, rows), generator=g)
    cond, lpc_rev = wn.step_inputs(model, model.cfg, feat.to(device),
                                   periods.to(device),
                                   wn.sample_lpc(lpc.to(device)))
    eps = eps.to(device)
    chunks = wn.GenerateChunks(model, rows, device, capture=False)
    k = chunks.chunk
    with torch.no_grad(), no_tf32():
        chunks._project(cond[:wn.COND_BLOCK])
        for c in range(warm + 1):
            chunks.eps.copy_(eps[c * k:(c + 1) * k])
            chunks.lpc.copy_(lpc_rev[c * k:(c + 1) * k])
            if c < warm:
                chunks._plain_chunk()
    return chunks


def state(chunks: wn.GenerateChunks) -> Dict[str, torch.Tensor]:
    return {n: getattr(chunks, n).clone() for n in STATE}


def restore(chunks: wn.GenerateChunks, st: Dict[str, torch.Tensor]) -> None:
    for n in STATE:
        getattr(chunks, n).copy_(st[n])


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """Each carried buffer's largest difference over its largest value
    (pos: its difference)."""
    out = {}
    for n in STATE:
        a, b = got[n].double(), want[n].double()
        if n == "pos":
            out[n] = float((a - b).abs())
        else:
            out[n] = float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30))
    return out


def kernel_and_plain(chunks: wn.GenerateChunks):
    """From the chunks' state: the state after one kernel chunk and after
    one plain chunk; the state is restored after each."""
    start = state(chunks)
    with torch.no_grad(), no_tf32():
        chunks._chunk()
        got = state(chunks)
        restore(chunks, start)
        chunks._plain_chunk()
        want = state(chunks)
        restore(chunks, start)
    return got, want


def least_step(cfg: wn.WavenetConfig, rows: int,
               projection: bool = False) -> Tuple[float, str]:
    """The least time of the kernel's step of `rows` rows: its
    multiply-adds (the front, the taps, the residual and skip product,
    the finals) at the float32 peak, or its weights read once from HBM,
    the larger.  With `projection`, the whole step's, the conditioning's
    projection (GenerateChunks._project, outside the kernel) included,
    as the benchmark counts it.  -> (microseconds, "operations" or
    "bytes": which bounds it)."""
    rc, gc, sc, cc = (cfg.residual_channels, cfg.gate_channels,
                      cfg.skip_channels, cfg.cout_channels)
    n = cfg.num_blocks * cfg.num_layers
    macs = (cfg.front_kernel * rc
            + n * (2 * rc * 2 * gc + projection * cc * 2 * gc
                   + gc * (rc + sc))
            + sc * sc + sc * cfg.out_channels)
    biases = rc + n * (4 * gc + rc + sc) + sc + cfg.out_channels
    ops_s = 2.0 * macs * rows / F32_FLOPS
    bytes_s = 4.0 * (macs + biases) / HBM_BYTES_S
    return (1e6 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def least_step_us(cfg: wn.WavenetConfig, rows: int,
                  projection: bool = False) -> float:
    return least_step(cfg, rows, projection)[0]


def replayed(fn, device) -> torch.cuda.CUDAGraph:
    """fn captured as a graph on the capture stream, after one warm-up
    there, as GenerateChunks captures its chunk."""
    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), no_tf32():
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
    torch.cuda.synchronize(device)
    return graph


def step_us(chunks: wn.GenerateChunks, fn, reps: int) -> float:
    graph = replayed(fn, chunks.device)
    return 1e3 * timing.median_ms(graph.replay, chunks.x, reps) / chunks.chunk


def measure(model: wn.Wavenet, rows: int, device, reps: int
            ) -> Dict[str, object]:
    chunks = carried(model, rows, device, seed=rows)
    got, want = kernel_and_plain(chunks)
    return {"rows": rows,
            "kernel_us_step": step_us(chunks, chunks._chunk, reps),
            "plain_graph_us_step": step_us(chunks, chunks._plain_chunk,
                                           reps),
            "least_step_us": least_step_us(model.cfg, rows),
            "least_step_us_with_projection": least_step_us(
                model.cfg, rows, projection=True),
            "smem_bytes": wavenet_step.smem_bytes(chunks.shape),
            "max_rel_diff": compare(got, want)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="1,8,64")
    ap.add_argument("--reps", type=int, default=timing.REPS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    timing.card(dev)
    at = where(dev)
    model = wavenet(dev)
    lines = []
    for rows in (int(r) for r in args.rows.split(",")):
        line = json.dumps({"kind": "wavenet_step",
                           **measure(model, rows, dev, args.reps), **at})
        lines.append(line)
        print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
