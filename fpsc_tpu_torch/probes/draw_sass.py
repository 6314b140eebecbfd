"""The instruction bound of the draw probe's kernel, from its SASS.

    python -m fpsc_tpu_torch.probes.draw_sass [b] [iters] [library kernel warps]

probe_draw_tail.bound counts 13 f32 operations a level and draw at the
67 TFLOP/s f32 rate, as if the card's lanes all worked on it.  But a
draw is a chain of dependent steps inside one column, and a warp issues
at most one instruction a clock.  This builds csrc/probe_draw_tail.cu,
disassembles it with cuobjdump -sass (gates_sass.sass), takes the full
arm's instance that the launcher picks at b columns
(draw_kernel<1, W, count>, W from fpsc_probe_draw_tail_warps)
and counts its loop (gates_sass.loop_counts): the instruction slots of
its shortest pass, which leaves out the scan of a column with a level
cut to 0 (no column of the probe's data has one; the ranges left out
are printed), and its draws, the FMULs by the update's 1e-3.  With the card's SM
count and its maximum SM clock (gates_sass.max_sm_clock_hz) it prints
the issue bound of `iters` draws:

    b * W <= 4 * SMs:  slots a draw x iters / clock
    else:              b * W * slots a draw x iters / (4 * SMs * clock)

(each warp on a scheduler of its own issues one instruction a clock;
with more warps than the card's 4 * SMs schedulers, all of them issue
one a clock).  Given a library, the mangled name of a kernel in it and
its warps a column, it counts that kernel instead (another build of the
probe, as of an earlier tree).  Without a card or nvcc it raises.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

import torch

from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.probes import gates_sass, probe_draw_tail
from fpsc_tpu_torch.probes.timing import card

# the update's 1e-3f, as cuobjdump prints an f32 immediate (in
# hexadecimal or in decimal)
DRAW_FACTOR = r"0x3a83126f|0\.00100000004"


def kernel(warps: int) -> str:
    """The mangled name's stem of the full arm's launcher instance at
    `warps` a column: draw_kernel<1, warps, 0>."""
    return f"draw_kernelILi1ELi{warps}ELi0EE"


def issue_ms(slots: float, b: int, warps: int, iters: int, sms: int,
             clock: float) -> float:
    """The issue bound of `iters` draws of b columns at `warps` a column."""
    n = b * warps
    schedulers = probe_draw_tail.SCHEDULERS * sms
    per_clock = 1.0 if n <= schedulers else schedulers / n
    return slots * iters / per_clock / clock * 1e3


def main(b: int = probe_draw_tail.DEFAULT[0],
         iters: int = probe_draw_tail.DEFAULT[1], library: str = None,
         name: str = None, warps: int = None) -> Dict[str, float]:
    """Print the loop's counts and the bound they set -> a dict of them."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the SASS and the clock are the "
                           "card's")
    card_name = card(torch.device("cuda"))
    if library is None:
        library = build.build([probe_draw_tail.SOURCE])[probe_draw_tail.SOURCE]
        warps = build.load(probe_draw_tail.SOURCE).fpsc_probe_draw_tail_warps(b)
        name = kernel(warps)
    counts = gates_sass.loop_counts(gates_sass.sass(Path(library), name),
                                    DRAW_FACTOR)
    draws = counts["evaluations"]
    if draws < 1:
        raise RuntimeError(f"no FMUL by {DRAW_FACTOR} in the loop: {counts}")
    slots = counts["path"] / draws
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = gates_sass.max_sm_clock_hz()
    ms = issue_ms(slots, b, warps, iters, sms, clock)
    flop_ms = probe_draw_tail.bound("full", b, iters)[0]
    print(f"{name} loop: {counts['instructions']} instructions, "
          f"{counts['skipped']} of them off its shortest pass "
          f"({gates_sass.skipped_text(counts)}), "
          f"{counts['mufu']} MUFU ({', '.join(counts['mufu_kinds'])}), "
          f"{counts['branches']} branches, {draws} draws: {slots:.1f} "
          f"instruction slots a warp and draw, {warps} warps a column "
          f"[{card_name}]")
    print(f"{sms} SMs, max SM clock {clock / 1e6:.0f} MHz; {b} columns x "
          f"{iters} draws: issue bound {ms:.5f} ms; the f32-rate bound "
          f"probe_draw_tail.bound counts {flop_ms:.5f} ms [{card_name}]")
    return {"slots": slots, "warps": warps, "issue_ms": ms,
            "clock_hz": clock, "sms": sms}


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*(int(a) for a in args[:2]), *args[2:4],
         *(int(a) for a in args[4:5]))
