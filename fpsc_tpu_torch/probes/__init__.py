"""Micro-benchmarks of the parts of the sampler kernel, on the card.

Ports of the TPU probes in scripts/probe_{gates,draw_tail,wide_store,
i8_matmul}.py.  Each probe module holds a hand-written CUDA kernel
(csrc/probe_*.cu) that runs every arm of its script, the wrapper that
launches it, the plain PyTorch version with the same arithmetic, and
`main`, the entry point:

    python -m fpsc_tpu_torch.probes.probe_gates [b] [iters]
    python -m fpsc_tpu_torch.probes.probe_draw_tail [b] [iters]
    python -m fpsc_tpu_torch.probes.probe_wide_store [b] [rows]
    python -m fpsc_tpu_torch.probes.probe_i8_matmul [m] [k] [b]

Each makes its script's inputs from np.random.RandomState(0) in the
script's order and prints one line per arm in the script's unit: the
median of 9 timed runs (CUDA events, after a warm-up) and the card's
name.  Without a card they raise.  A kernel that does not build or
launch raises too: no arm is skipped.

Beside them, chain_parts, draw_parts (the draw's and the wide store's
template instances) and gates_sass and draw_sass (instruction bounds
from the kernels' SASS) take the probes apart on the card, and
span_cost measures what the span recorder (utils/logging.py) costs a
live duplex tick.

This module holds what the wrappers share: the operand check and the
launch of a kernel through its plain C interface.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from fpsc_tpu_torch.ops import build


def check_operand(what: str, x: torch.Tensor, shape: Tuple[int, ...],
                  dtype: torch.dtype, device: torch.device) -> None:
    """Raise ValueError unless x has this shape and dtype, lies on
    `device` and is contiguous."""
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: dtype {x.dtype}, expected {dtype}")
    if x.device != device:
        raise ValueError(f"{what} is on {x.device}, the other operands on "
                         f"{device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} is not contiguous")


def operand_device(x: torch.Tensor) -> torch.device:
    """The device a probe runs on: the kernel's for a CUDA tensor, the
    plain version's for a CPU tensor."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {x.device}")
    return x.device


def launch(source: str, symbol: str, argtypes: Sequence, name: str,
           device: torch.device, *args) -> None:
    """Call the C function `symbol` of csrc/`source` (built at first
    use) with args and the current stream, counting one launch of
    `name`; raise if the kernel was not launched."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.count_launch(name)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
