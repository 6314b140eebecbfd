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
    if arm not in ARMS:
        raise ValueError(f"probe_wide_store arms are {ARMS}, not {arm!r}")
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
    launch(SOURCE, "fpsc_probe_wide_store", [i, p, p, i, i],
           kernel_name(arm), dev, ARMS.index(arm), x.data_ptr(),
           out.data_ptr(), b, rows)
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


def bound(arm: str, b: int, rows: int) -> Tuple[float, str]:
    """The least time on the card's published HBM3 rate -> (ms, "bytes"):
    the carry read once, the defined rows written once.  The adds (b per
    row) are far below the bytes."""
    nbytes = (CARRY + written_rows(arm, rows)) * b * 4
    return nbytes / PEAK_BYTES * 1e3, "bytes"


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
