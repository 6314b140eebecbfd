"""Where the draw and the wide store spend their time: their design
variants, timed.

    python -m fpsc_tpu_torch.probes.draw_parts

The draw probe's full arm at 64 draws of 8, 100, 256 and 768 columns
(8: the sampler's flagship batch; 100: columns that fill no block of
columns), on each template instance of csrc/probe_draw_tail.cu: each of
WARPS warps a column, with the count-and-lookup decode (the launcher's)
and with the float-sum decode.  The wide-store probe at its default
(768, 2048), each arm on blocks of each of COLS columns; then the none
arm at 8 x 2048 rows, whose 2048 adds are per_row's chain without its
stores.  Each variant is first held to its plain version by the
probe's check, then timed by the probes' timer: one line each, the
median ms of one run and its us a draw or row.  Without a card it
raises.
"""
from __future__ import annotations

from typing import Dict

from fpsc_tpu_torch.probes import probe_draw_tail as pdt
from fpsc_tpu_torch.probes import probe_wide_store as pws
from fpsc_tpu_torch.probes.timing import card, median_ms
from fpsc_tpu_torch.utils.device import resolve_device

DRAW_GEOMETRIES = tuple((b, pdt.DEFAULT[1]) for b in (8, 100, 256,
                                                      pdt.DEFAULT[0]))


def draw(dev, name: str) -> Dict[tuple, float]:
    times = {}
    for b, iters in DRAW_GEOMETRIES:
        ops = pdt.operands("full", b, iters, dev)
        for decode in pdt.DECODES:
            want = pdt.run_plain("full", *ops, decode=decode)
            for warps in pdt.WARPS:
                def fn():
                    return pdt.run_variant("full", *ops, warps=warps,
                                           decode=decode)
                pdt.check("full", fn(), want)
                ms = median_ms(fn, ops[0])
                print(f"draw full at ({b}, {iters}), {warps} warps a column, "
                      f"{decode} decode: {ms:.4f} ms, "
                      f"{ms * 1e3 / iters:.3f} us a draw [{name}]", flush=True)
                times["draw", b, warps, decode] = ms
    return times


def store(dev, name: str) -> Dict[tuple, float]:
    b, rows = pws.DEFAULT
    times = {}
    for arm in pws.ARMS:
        x, _ = pws.operands(arm, b, rows, dev)
        want = pws.run_plain(arm, x, rows)
        for cols in pws.COLS:
            def fn():
                return pws.run_variant(arm, x, rows, cols=cols)
            pws.check(arm, fn(), want)
            ms = median_ms(fn, x)
            print(f"store {arm} at ({b}, {rows}), {cols} columns a block: "
                  f"{ms:.4f} ms, {ms * 1e3 / rows:.4f} us a row [{name}]",
                  flush=True)
            times["store", arm, cols] = ms
    # per_row's chain of `rows` adds without its stores: none at 8 x rows
    x, _ = pws.operands("none", b, rows, dev)
    ms = median_ms(lambda: pws.run("none", x, pws.CARRY * rows), x)
    print(f"store none at ({b}, {pws.CARRY * rows}): {rows} adds, no "
          f"stores: {ms:.4f} ms [{name}]", flush=True)
    times["store", "chain alone"] = ms
    return times


def main(device=None) -> Dict[tuple, float]:
    """Time every variant -> {(probe, ...variant): ms}."""
    dev = resolve_device(device)
    name = card(dev)
    return {**draw(dev, name), **store(dev, name)}


if __name__ == "__main__":
    main()
