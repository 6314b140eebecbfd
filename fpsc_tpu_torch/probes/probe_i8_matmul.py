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
from typing import Dict, Optional, Tuple

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
# The chain kernels' launch: CTAs a thread-block cluster, each cluster
# carrying CHAIN_COLS columns of x.  W's rows are split over the
# cluster's CTAs, each holding its stripe in shared memory, at most
# SMEM_BYTES a CTA (the card's 232,448 less the bf16 and i8 kernels' two
# barriers).  CLUSTER CTAs, the fastest size of every arm at the default
# geometry (chain_parts.py), or the first of LARGER_CLUSTERS where W's
# stripe would not fit (16 is a non-portable size).
# csrc/probe_i8_matmul.cu names the same kChainCols and kChainSmem.
CLUSTER = 6
LARGER_CLUSTERS = (8, 16)
CHAIN_COLS = 8
SMEM_BYTES = 232432


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
    if cluster_ctas(m, k, arm) is None:
        ctas = LARGER_CLUSTERS[-1]
        raise ValueError(f"the {arm} chain holds W in the shared memory of "
                         f"a cluster of at most {ctas} CTAs: a stripe of W "
                         f"{tuple(w.shape)} needs "
                         f"{cluster_smem(m, k, ctas, arm)} bytes a CTA, "
                         f"more than {SMEM_BYTES}")
    return dev


def cluster_ctas(m: int, k: int, arm: str = "bf16"):
    """The CTAs of a cluster of the arm's chain at W (m, k): CLUSTER, or
    the first of LARGER_CLUSTERS at which W's stripe fits one CTA's
    shared memory; None where none fits."""
    for ctas in (CLUSTER, *LARGER_CLUSTERS):
        if cluster_smem(m, k, ctas, arm) <= SMEM_BYTES:
            return ctas
    return None


def cluster_smem(m: int, k: int, ctas: int, arm: str = "bf16") -> int:
    """The shared memory of one CTA of the arm's chain on clusters of
    `ctas` CTAs (csrc cluster_smem): its stripe of W, the rows below k
    and those above each split over the CTAs in 16-row tiles, and two
    buffers of the cluster's CHAIN_COLS columns of x (bf16, i8) or W's
    first 16 rows (onehot); each row of W and column of x is its depth
    in bytes padded to 64, then by 16 more."""
    pp = -(-(k // 16) // ctas)
    qq = -(-((m - k) // 16) // ctas)
    depth = _depth(arm, k) * (2 if arm == "bf16" else 1)
    row = -(-depth // 64) * 64 + 16
    extra = 16 if arm == "onehot" else 2 * CHAIN_COLS
    return ((pp + qq) * 16 + extra) * row


def run(arm: str, w: torch.Tensor, x: torch.Tensor,
        iters: int = ITERS) -> torch.Tensor:
    """`iters` chained products of the arm -> (k, b) f32.  CUDA tensors
    launch the kernel (one launch for the whole chain, on thread-block
    clusters of cluster_ctas(m, k, arm) CTAs) or raise, also where the
    card refuses the cluster or its shared memory; CPU tensors run
    `run_plain`."""
    dev = _check(arm, w, x, iters)
    if dev.type == "cpu":
        return run_plain(arm, w, x, iters)
    return run_chain(arm, w, x, iters)


# What a timing variant of the bf16 or i8 kernel leaves out of each
# product (csrc Skip): its products, or its stores of x to the cluster's
# peers.  The onehot kernel exchanges nothing and has no variants.
SKIP = {"products": 1, "exchange": 2}


def run_chain(arm: str, w: torch.Tensor, x: torch.Tensor,
              iters: int = ITERS, ctas: Optional[int] = None,
              skip: Tuple[str, ...] = ()) -> torch.Tensor:
    """The arm's kernel on CUDA tensors that passed `_check`, on clusters
    of `ctas` CTAs (by default cluster_ctas(m, k, arm)); with `skip`, a
    timing variant that leaves those parts of each product out (its
    output is not the chain's), counted under kernel_name(arm) +
    "_variant"."""
    k, b = x.shape
    if ctas is None:
        ctas = cluster_ctas(w.shape[0], k, arm)
    out = torch.empty((k, b), dtype=torch.float32, device=x.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch(SOURCE, "fpsc_probe_i8_matmul", [i, p, p, p] + [i] * 6,
           kernel_name(arm) + ("_variant" if skip else ""), x.device,
           ARMS.index(arm), w.data_ptr(), x.data_ptr(), out.data_ptr(),
           w.shape[0], k, b, iters, ctas, sum(SKIP[s] for s in skip))
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


def check_product(got: torch.Tensor, w: torch.Tensor,
                  x: torch.Tensor) -> float:
    """Hold one product of the bf16 chain, got = bf16(W @ bf16(x))[:k],
    to the plain product element by element -> max |got - want|; raise
    where an element differs by more than a bf16 rounding of each side,
    2^-8 (|got| + |want|) with a margin of 2^-7 of that, plus twice
    k 2^-23 (|W| @ |bf16(x)|), the rounding of an f32 sum of k terms
    even where the tensor cores truncate.  An x read stale or half
    written in a column moves its elements by about their own size."""
    k = x.shape[0]
    wf = w.detach().cpu().float()
    xb = x.detach().cpu().to(torch.bfloat16).float()
    got = got.detach().cpu().float()
    want = (wf @ xb)[:k].to(torch.bfloat16).float()
    sums = (wf.abs() @ xb.abs())[:k]
    tol = (2.0 ** -8 * (1 + 2.0 ** -7) * (got.abs() + want.abs())
           + 2 * k * 2.0 ** -23 * sums)
    diff = (got - want).abs()
    bad = diff > tol
    if bad.any():
        r, c = (int(i) for i in bad.nonzero()[0])
        raise RuntimeError(
            f"probe_i8_matmul bf16: one product differs at {int(bad.sum())} "
            f"elements, first ({r}, {c}): {float(got[r, c])!r} against "
            f"{float(want[r, c])!r}, tolerance {float(tol[r, c]):.3g}")
    return float(diff.max())


def check_step(arm: str, got: torch.Tensor, w: torch.Tensor,
               x: torch.Tensor) -> float:
    """Hold one product of the arm's chain, got, to one plain product of
    x (on the CPU) -> max |got - want|: bf16 by `check_product`; the
    exact arms must equal it bit for bit, or this raises."""
    if arm == "bf16":
        return check_product(got, w, x)
    want = run_plain(arm, w.detach().cpu(), x.detach().cpu(), 1)
    got = got.detach().cpu()
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        r, c = (int(i) for i in bad[0])
        raise RuntimeError(
            f"probe_i8_matmul {arm}: one product differs at {len(bad)} "
            f"elements, first ({r}, {c}): {float(got[r, c])!r} against "
            f"{float(want[r, c])!r}")
    return 0.0


def check_kernel_products(arm: str, w: torch.Tensor, x: torch.Tensor,
                          products: int = 4) -> float:
    """The arm's chain kernel on CUDA operands, stopped after each of its
    first `products` products, each held by `check_step` to one plain
    product of the kernel's result before (x itself for the first) ->
    the largest max |got - want|.  Four products reach both of x's
    buffers twice each."""
    err, before = 0.0, x
    for iters in range(1, products + 1):
        got = run(arm, w, x, iters)
        err = max(err, check_step(arm, got, w, before))
        before = got
    return err


def check_kernel_repeats(arm: str, w: torch.Tensor, x: torch.Tensor,
                         repeats: int = 8) -> None:
    """The arm's chain kernel on CUDA operands, `repeats` times: every
    element sums in a fixed order, so the runs must agree bit for bit,
    and a race in the exchange of x shows as runs that differ."""
    first = run(arm, w, x)
    for i in range(1, repeats):
        if not torch.equal(run(arm, w, x), first):
            raise RuntimeError(f"probe_i8_matmul {arm}: run {i} of the "
                               f"chain differs from run 0")


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


# the `kernels` line's bound: the published rates alone, as `bound` is
rate_bound = bound


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
