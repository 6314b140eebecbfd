"""What does an int8 tensor-core product cost on the card, against bf16?

Port of scripts/probe_i8_matmul.py (bf16_kernel, i8_kernel and
onehot_i8_kernel, pallas_call at :63 and :115) as csrc/probe_i8_matmul.cu.
The sampler kernel converts int8 weights to float one at a time
(ROADMAP Queue D 5); quantising the activations too would let the
products run on the int8 tensor cores, which Hopper rates at twice its
bf16 peak.  This probe asks what that buys at GRU_A's geometry,
(1152, 384) @ (384, b), on a chain of ITERS products that each need the
whole result of the one before:

  bf16    x <- bf16(W @ x)[:k], W bf16, f32 accumulation
  i8      xq = clip(round(127 x), +-127) as int8, x <- (Wq @ xq)[:k] in
          int32, times the f32 constant 1/127^2
  onehot  idx = int(clip(x[0], 0, 255)), x <- (W_emb @ onehot(idx))[:k]
          in int32, times 1e-4: the embedding gather as a product

    python -m fpsc_tpu_torch.probes.probe_i8_matmul [m] [k] [b]

One line per arm: the median us per product over 9 timed chains, and
TOP/s counting 2 m k b operations a product (2 m 256 b for onehot).
All m rows of each product are computed, though only the first k feed
the next.  The i8 and onehot arms are exact: every partial sum is an
integer below 2^24, so the plain version's float32 product gives the
same sums.
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

SOURCE = "probe_i8_matmul.cu"
ITERS = 64
ARMS = ("bf16", "i8", "onehot")
EMB_ROWS = 256
# JAX multiplies by the f32 rounding of these Python floats
INV_127_SQ = 1.0 / (127.0 * 127.0)
ONEHOT_SCALE = 1e-4
# Published dense tensor-core peaks of one H100 SXM, and its HBM3 rate
PEAK_OPS = {"bf16": 989e12, "i8": 1979e12, "onehot": 1979e12}
PEAK_BYTES = 3.35e12
# The bf16 chain's f32 sums run in another order in each version, so an
# element now and then rounds to the neighbouring bf16 value, and over
# 64 products such steps spread through the chain: the largest
# difference allowed, as a share of the largest element (1.3% seen
# between the plain version and the script's kernel on the CPU).
BF16_CHAIN_TOL = 0.05

# the script's (m, k, b)
DEFAULT = (1152, 384, 128)


def kernel_name(arm: str) -> str:
    return f"probe_i8_matmul_{arm}"


def inputs(m: int, k: int, b: int, device) -> Dict[str, torch.Tensor]:
    """The script's operands, drawn in its order from RandomState(0):
    W as bf16 and as int8 scaled by its largest magnitude, x, and the
    int8 embedding table."""
    rng = np.random.RandomState(0)
    w_f = torch.as_tensor(rng.randn(m, k).astype(np.float32) * 0.05)
    x = torch.as_tensor(rng.randn(k, b).astype(np.float32) * 0.5)
    w_emb = torch.as_tensor(rng.randint(-127, 128, (m, EMB_ROWS))
                            .astype(np.int8))
    wq = torch.clamp(torch.round(w_f / w_f.abs().max() * 127), -127, 127)
    return {"bf16": w_f.to(torch.bfloat16).to(device),
            "i8": wq.to(torch.int8).to(device),
            "onehot": w_emb.to(device), "x": x.to(device)}


def operands(arm: str, m: int, k: int, b: int, device) -> tuple:
    """The arguments of run(arm, ...) and run_plain(arm, ...) at (m, k,
    b): the arm's W and x."""
    ops = inputs(m, k, b, device)
    return ops[arm], ops["x"]


def _depth(arm: str, k: int) -> int:
    return EMB_ROWS if arm == "onehot" else k


def _check(arm: str, w: torch.Tensor, x: torch.Tensor, iters: int):
    if arm not in ARMS:
        raise ValueError(f"probe_i8_matmul arms are {ARMS}, not {arm!r}")
    dev = operand_device(x)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("probe_i8_matmul takes a 2-d W and a 2-d x")
    k, b = x.shape
    m = w.shape[0]
    check_operand("x", x, (k, b), torch.float32, dev)
    check_operand("W", w, (m, _depth(arm, k)),
                  torch.bfloat16 if arm == "bf16" else torch.int8, dev)
    if m % 16 or k % 32 or b % 8 or not 0 < k <= m or iters < 1:
        raise ValueError(f"probe_i8_matmul takes m a multiple of 16, k of "
                         f"32 and at most m, b of 8, iters >= 1; got m={m}, "
                         f"k={k}, b={b}, iters={iters}")
    return dev


def run(arm: str, w: torch.Tensor, x: torch.Tensor,
                 iters: int = ITERS) -> torch.Tensor:
    """`iters` chained products of the arm -> (k, b) f32.  CUDA tensors
    launch the kernel (one launch for the whole chain) or raise; CPU
    tensors run `run_plain`."""
    dev = _check(arm, w, x, iters)
    if dev.type == "cpu":
        return run_plain(arm, w, x, iters)
    k, b = x.shape
    out = torch.empty((k, b), dtype=torch.float32, device=dev)
    # the chain's ping-pong buffers: bf16 for the bf16 arm, else f32
    xbuf = torch.empty((2, k, b), dtype=torch.bfloat16 if arm == "bf16"
                       else torch.float32, device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch(SOURCE, "fpsc_probe_i8_matmul", [i, p, p, p, p, i, i, i, i],
           kernel_name(arm), dev, ARMS.index(arm), w.data_ptr(),
           x.data_ptr(), out.data_ptr(), xbuf.data_ptr(), w.shape[0], k,
           b, iters)
    return out


def run_plain(arm: str, w: torch.Tensor, x: torch.Tensor,
                       iters: int = ITERS) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  The products run in
    float32 on the operands' values: exact for the i8 and onehot arms
    (integer partial sums below 2^24), for bf16 the f32 sum in another
    order than the tensor cores'."""
    k = x.shape[0]
    wf = w.float()
    if arm == "bf16":
        acc = x.to(torch.bfloat16)
        for _ in range(iters):
            acc = (wf @ acc.float())[:k].to(torch.bfloat16)
        return acc.float()
    acc = x
    for _ in range(iters):
        if arm == "i8":
            acc = (wf @ quantize(acc))[:k] * INV_127_SQ
        else:
            acc = (wf @ onehot(acc))[:k] * ONEHOT_SCALE
    return acc


def quantize(acc: torch.Tensor) -> torch.Tensor:
    """The i8 arm's activations: clip(round-half-even(127 acc), +-127),
    int8 values held in acc's float dtype."""
    return torch.clamp(torch.round(acc * 127.0), -127, 127)


def onehot(acc: torch.Tensor) -> torch.Tensor:
    """The onehot arm's operand: column i is one-hot at int(clip(acc[0, i],
    0, 255)) (truncated), (256, b) in acc's float dtype."""
    idx = torch.clamp(acc[0], 0, 255).to(torch.int32)
    levels = torch.arange(EMB_ROWS, device=acc.device)[:, None]
    return (levels == idx).to(acc.dtype)


def check(arm: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; raise unless the i8 and onehot arms agree bit
    for bit and the bf16 arm within BF16_CHAIN_TOL of the peak."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    err = float((got - want).abs().max())
    peak = float(want.abs().max())
    ok = (err <= BF16_CHAIN_TOL * peak if arm == "bf16"
          else torch.equal(got, want))
    if not ok:
        raise RuntimeError(f"probe_i8_matmul {arm}: max |difference| {err:.3g}"
                           f" at peak {peak:.3g}")
    return err


def bound(arm: str, m: int, k: int, b: int,
          iters: int = ITERS) -> Tuple[float, str]:
    """The least time of the chain on the card's published peaks ->
    (ms, "operations" or "bytes"): 2 m depth b operations a product on
    the tensor cores; W and x read once, the output written once."""
    depth = _depth(arm, k)
    ops = 2.0 * m * depth * b * iters
    nbytes = m * depth * (2 if arm == "bf16" else 1) + 2 * k * b * 4
    t_ops, t_bytes = ops / PEAK_OPS[arm] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main(m: int = DEFAULT[0], k: int = DEFAULT[1], b: int = DEFAULT[2],
         device=None) -> Dict[str, float]:
    """Time every arm on the card and print one line each -> {arm: ms
    of one chain of ITERS products}."""
    dev = resolve_device(device)
    ops = inputs(m, k, b, dev)
    name = card(dev)
    times = {}
    for arm in ARMS:
        ms = median_ms(lambda: run(arm, ops[arm], ops["x"]),
                       ops["x"])
        us = ms * 1e3 / ITERS
        tops = 2.0 * m * _depth(arm, k) * b / (us * 1e-6) / 1e12
        print(line(arm, us, "us/matmul", name, f" ({tops:.1f} TOP/s)"),
              flush=True)
        times[arm] = ms
    return times


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
