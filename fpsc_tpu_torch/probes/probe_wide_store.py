"""What do the sampler's per-sample output stores cost on the card?

Port of scripts/probe_wide_store.py (make -> kernel, pallas_call at :54)
as csrc/probe_wide_store.cu.  The sampler kernel writes each drawn
sample to device memory as it goes; the alternative is to gather 8
samples and store them as one (8, b) block.  This probe times the two
store patterns of an (8, b) f32 carry that takes +1e-6 an iteration:

  none      rows/8 iterations, no store in the loop
  per_row   rows iterations, each storing carry row 0 at row t
  block8    rows/8 iterations, each storing all 8 rows at row 8t

After the loop rows 0-7 take the final carry.  In `none` the other rows
of the output are never written (torch.empty, as the TPU output is).

    python -m fpsc_tpu_torch.probes.probe_wide_store [b] [rows]

One line per arm: the median us per output row over 9 timed runs.
Every arm is exact: the same f32 adds in the same order.

Each carry is a chain of dependent f32 adds, so besides the bytes the
chain bounds an arm: its iterations at ADD_LATENCY cycles each, at the
SM clock SM_CLOCK_HZ.  per_row's 2,048 adds (4.1 us) outlast its bytes
(1.9 us at the defaults).  The kernel's instances (COLS columns a
block) are timed by draw_parts.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from fpsc_tpu_torch.probes import check_operand, launch, operand_device
from fpsc_tpu_torch.probes.timing import card, line, median_ms
from fpsc_tpu_torch.utils.device import resolve_device

SOURCE = "probe_wide_store.cu"
ARMS = ("none", "per_row", "block8")
CARRY = 8
STEP = 1e-6
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# The dependent f32 add: its latency in cycles and the SM clock it runs
# at, the H100's maximum (1980 MHz as nvidia-smi read it, PERF.md §6).
ADD_LATENCY = 4
SM_CLOCK_HZ = 1.98e9
# columns a block of the kernel's instances, and the launcher's for each
# arm (the C source's kLauncherCols)
COLS = (8, 32)
LAUNCHER_COLS = {"none": 8, "per_row": 32, "block8": 8}

# the script's (b, rows)
DEFAULT = (768, 2048)


def kernel_name(arm: str) -> str:
    return f"probe_wide_store_{arm}"


def inputs(b: int, device) -> torch.Tensor:
    """The script's carry, (8, b) f32 from RandomState(0)."""
    x = np.random.RandomState(0).randn(CARRY, b).astype(np.float32)
    return torch.as_tensor(x).to(device)


def iterations(arm: str, rows: int) -> int:
    return rows if arm == "per_row" else rows // CARRY


def written_rows(arm: str, rows: int) -> int:
    """The rows of the output an arm defines (the first ones)."""
    return CARRY if arm == "none" else rows


def operands(arm: str, b: int, rows: int, device) -> tuple:
    """The arguments of run(arm, ...) and run_plain(arm, ...) at (b,
    rows)."""
    return inputs(b, device), rows


def run(arm: str, x: torch.Tensor, rows: int) -> torch.Tensor:
    """The arm's stores of the carry x -> (rows, b) f32, of which the
    first written_rows(arm, rows) are defined.  CUDA tensors launch the
    kernel or raise; CPU tensors run `run_plain`."""
    return run_variant(arm, x, rows)


def run_variant(arm: str, x: torch.Tensor, rows: int,
                cols: int = 0) -> torch.Tensor:
    """`run` on one template instance: `cols` of COLS columns a block (0:
    the launcher's)."""
    if arm not in ARMS:
        raise ValueError(f"probe_wide_store arms are {ARMS}, not {arm!r}")
    cols = cols or LAUNCHER_COLS[arm]
    if cols not in COLS:
        raise ValueError(f"probe_wide_store has no instance of {arm} with "
                         f"{cols} columns a block")
    dev = operand_device(x)
    b = x.shape[-1]
    check_operand("x", x, (CARRY, b), torch.float32, dev)
    if rows < CARRY or rows % CARRY or b < 1:
        raise ValueError(f"probe_wide_store takes rows a positive multiple "
                         f"of {CARRY}, not {rows}")
    if dev.type == "cpu":
        return run_plain(arm, x, rows)
    out = torch.empty((rows, b), dtype=torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    args = (ARMS.index(arm), x.data_ptr(), out.data_ptr(), b, rows)
    if cols == LAUNCHER_COLS[arm]:
        launch(SOURCE, "fpsc_probe_wide_store", [i, p, p, i, i],
               kernel_name(arm), dev, *args)
    else:
        launch(SOURCE, "fpsc_probe_wide_store_variant", [i, p, p, i, i, i],
               kernel_name(arm), dev, *args, cols)
    return out


def run_plain(arm: str, x: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.empty((rows, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    carry = x.clone()
    for t in range(iterations(arm, rows)):
        carry = carry + STEP
        if arm == "per_row":
            out[t] = carry[0]
        elif arm == "block8":
            out[CARRY * t:CARRY * (t + 1)] = carry
    out[:CARRY] = carry
    return out


def check(arm: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the rows the arm defines; raise unless they
    agree bit for bit."""
    n = written_rows(arm, got.shape[0])
    got, want = got[:n].detach().cpu(), want[:n].detach().cpu()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise RuntimeError(f"probe_wide_store {arm}: max |difference| "
                           f"{err:.3g} over the first {n} rows")
    return err


def bound_terms(arm: str, b: int, rows: int) -> Dict[str, float]:
    """The least times in ms: "bytes", the carry read once and the
    defined rows written once at the published HBM3 rate; "operations",
    the adds at the f32 rate; "chain", the longest chain's adds one
    after another, ADD_LATENCY cycles each at SM_CLOCK_HZ."""
    n = iterations(arm, rows)
    return {"bytes": (CARRY + written_rows(arm, rows)) * b * 4
            / PEAK_BYTES * 1e3,
            "operations": CARRY * b * n / PEAK_F32 * 1e3,
            "chain": n * ADD_LATENCY / SM_CLOCK_HZ * 1e3}


def rate_bound(arm: str, b: int, rows: int) -> Tuple[float, str]:
    """The bound on the card's published rates alone -> (ms, "bytes" or
    "operations"): the `kernels` line's, as every probe's rate_bound."""
    terms = bound_terms(arm, b, rows)
    by = max(("bytes", "operations"), key=terms.get)
    return terms[by], by


def bound(arm: str, b: int, rows: int) -> Tuple[float, str]:
    """The least time -> (ms, by): the larger of the bytes and the add
    chain ("bytes" or "chain"); the adds' rate is far below both."""
    terms = bound_terms(arm, b, rows)
    by = max(("bytes", "chain"), key=terms.get)
    return terms[by], by


def main(b: int = DEFAULT[0], rows: int = DEFAULT[1],
         device=None) -> Dict[str, float]:
    """Time every arm on the card and print one line each -> {arm: ms
    of one run}."""
    dev = resolve_device(device)
    x = inputs(b, dev)
    name = card(dev)
    times = {}
    for arm in ARMS:
        ms = median_ms(lambda: run(arm, x, rows), x)
        print(line(arm, ms * 1e3 / rows, "us/row", name), flush=True)
        times[arm] = ms
    return times


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
