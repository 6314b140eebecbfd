"""What does GRU_A's gate math cost on the card at wide batch?

Port of scripts/probe_gates.py (make -> kernel, pallas_call at :85) as
csrc/probe_gates.cu.  Each GRU step of the sampler kernel evaluates
GRU_A's gates on (3*384, b) pre-activations: two sigmoids, a tanh and
the blend.  This probe times that evaluation alone, chained `iters`
times, h <- 0.999 gates(pre, gh, h):

  none        h <- h + 1e-6: the loop alone
  gates_f32   z = sigmoid(pre_z + gh_z), r = sigmoid(pre_r + gh_r),
              n = tanh(pre_n + r gh_n), h <- (1 - z) n + z h, in f32
  gates_bf16  the adds and multiplies in bf16 where the script casts
              (probe_gates.py:52-64), the transcendentals and the state
              in f32

pre and gh are (3H, b) in the script's row order [z; r; n]; h is (H, b).

    python -m fpsc_tpu_torch.probes.probe_gates [b] [iters]

One line per arm: the median us per gate evaluation over 9 timed runs.
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

SOURCE = "probe_gates.cu"
H = 384
ARMS = ("none", "gates_f32", "gates_bf16")
DECAY = 0.999
STEP = 1e-6
# f32 operations an element and evaluation, each elementary function
# counted as one: 3 adds and a multiply into the gates, 2 sigmoids and a
# tanh, then 1 - z, two multiplies and an add, and the decay
GATE_OPS = 12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# |h| stays below about 1 and the chain contracts (h <- 0.999 ((1 - z) n
# + z h)), so two versions whose sigmoid and tanh differ by an ulp or so
# stay within a few ulps (6e-7 seen on the CPU against the script's
# kernel).
TOL = 2e-6
# In bf16 such an ulp can round (1 - z), n or r to the neighbouring bf16
# value: an element then moves by up to two bf16 steps at |h| <= 1.  At
# most BF16_FLIPS of the elements may do so.
BF16_STEP = 2 * 2.0 ** -7
BF16_FLIPS = 1e-3

# the script's (b, iters)
DEFAULT = (768, 512)


def kernel_name(arm: str) -> str:
    return f"probe_gates_{arm}"


def inputs(b: int, device, h_units: int = H) -> Dict[str, torch.Tensor]:
    """The script's operands, drawn in its order from RandomState(0)."""
    rng = np.random.RandomState(0)
    pre = rng.randn(3 * h_units, b).astype(np.float32)
    gh = rng.randn(3 * h_units, b).astype(np.float32)
    h = rng.randn(h_units, b).astype(np.float32) * 0.1
    return {k: torch.as_tensor(v).to(device)
            for k, v in (("pre", pre), ("gh", gh), ("h", h))}


def operands(arm: str, b: int, iters: int, device) -> tuple:
    """The arguments of run(arm, ...) and run_plain(arm, ...) at (b,
    iters)."""
    ops = inputs(b, device)
    return ops["pre"], ops["gh"], ops["h"], iters


def run(arm: str, pre: torch.Tensor, gh: torch.Tensor, h: torch.Tensor,
          iters: int) -> torch.Tensor:
    """`iters` chained gate evaluations of the arm -> (H, b) f32.  CUDA
    tensors launch the kernel or raise; CPU tensors run `run_plain`."""
    if arm not in ARMS:
        raise ValueError(f"probe_gates arms are {ARMS}, not {arm!r}")
    dev = operand_device(h)
    if h.dim() != 2:
        raise ValueError("probe_gates takes h as (H, b)")
    hu, b = h.shape
    check_operand("h", h, (hu, b), torch.float32, dev)
    check_operand("pre", pre, (3 * hu, b), torch.float32, dev)
    check_operand("gh", gh, (3 * hu, b), torch.float32, dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, not {iters}")
    if dev.type == "cpu":
        return run_plain(arm, pre, gh, h, iters)
    out = torch.empty_like(h)
    p, i = ctypes.c_void_p, ctypes.c_int
    launch(SOURCE, "fpsc_probe_gates", [i, p, p, p, p, i, i, i],
           kernel_name(arm), dev, ARMS.index(arm), pre.data_ptr(),
           gh.data_ptr(), h.data_ptr(), out.data_ptr(), hu, b, iters)
    return out


def _f32_step(pre, gh, h, hu):
    z = torch.sigmoid(pre[:hu] + gh[:hu])
    r = torch.sigmoid(pre[hu:2 * hu] + gh[hu:2 * hu])
    n = torch.tanh(pre[2 * hu:] + r * gh[2 * hu:])
    return (1.0 - z) * n + z * h


def _bf16_step(pre, gh, h, hu):
    bf = torch.bfloat16
    p16, g16 = pre.to(bf), gh.to(bf)
    z = torch.sigmoid((p16[:hu] + g16[:hu]).float())
    r = torch.sigmoid((p16[hu:2 * hu] + g16[hu:2 * hu]).float())
    n = torch.tanh((p16[2 * hu:] + r.to(bf) * g16[2 * hu:]).float())
    return ((1.0 - z).to(bf) * n.to(bf)).float() + z * h


def run_plain(arm: str, pre: torch.Tensor, gh: torch.Tensor,
                h: torch.Tensor, iters: int) -> torch.Tensor:
    hu = h.shape[0]
    step = _bf16_step if arm == "gates_bf16" else _f32_step
    for _ in range(iters):
        h = h + STEP if arm == "none" else step(pre, gh, h, hu) * DECAY
    return h


def check(arm: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; raise unless `none` agrees bit for bit,
    gates_f32 within TOL, and gates_bf16 within TOL but for at most
    BF16_FLIPS of the elements, which stay within BF16_STEP."""
    got, want = got.detach().cpu(), want.detach().cpu()
    diff = (got - want).abs()
    err = float(diff.max())
    if arm == "none":
        ok = torch.equal(got, want)
    elif arm == "gates_f32":
        ok = err <= TOL
    else:
        flips = float((diff > TOL).float().mean())
        ok = err <= BF16_STEP and flips <= BF16_FLIPS
    if not ok:
        raise RuntimeError(f"probe_gates {arm}: max |difference| {err:.3g}, "
                           f"{int((diff > TOL).sum())} elements above {TOL}")
    return err


def bound(arm: str, b: int, iters: int,
          h_units: int = H) -> Tuple[float, str]:
    """The least time on the card's published peaks -> (ms, by): pre, gh
    and h read once and the output written once; GATE_OPS f32 operations
    an element and evaluation at the f32 peak outside the tensor cores
    (one add for `none`)."""
    ops = (1 if arm == "none" else GATE_OPS) * h_units * b * iters
    nbytes = (2 * 3 * h_units + 2 * h_units) * b * 4
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# the `kernels` line's bound: the published rates alone, as `bound` is
rate_bound = bound


def main(b: int = DEFAULT[0], iters: int = DEFAULT[1],
         device=None) -> Dict[str, float]:
    """Time every arm on the card and print one line each -> {arm: ms
    of one run of `iters` evaluations}."""
    dev = resolve_device(device)
    ops = operands(ARMS[0], b, iters, dev)
    name = card(dev)
    times = {}
    for arm in ARMS:
        ms = median_ms(lambda: run(arm, *ops), ops[0])
        print(line(arm, ms * 1e3 / iters, "us/gate-eval", name), flush=True)
        times[arm] = ms
    return times


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
