"""Where does the sampler's draw spend its time on the card?

Port of scripts/probe_draw_tail.py (make -> kernel, pallas_call at :118)
as csrc/probe_draw_tail.cu.  The draw of the sampler kernel
(csrc/lpcnet_sampler.cu `draw`): two tanh, exp, a column sum, a cut at
0.002 of it, an inclusive prefix sum over the 256 levels, and the count
below u * total.  This probe times that draw on (256, b) logits, chained
`iters` times, fcpre <- fcpre + 1e-3 draw(fcpre), with ablations:

  empty      fcpre <- fcpre + 1e-6: the loop alone
  full       the draw, its prefix sum the warp's register scan
  no_cumsum  the prefix sum left out
  no_exp     exp replaced by an affine map
  no_decode  the decode replaced by cdf[0] - u * total
  no_tanh    the two tanh replaced by scales
  tri_bf16   the prefix sum as the product of a triangle of ones with
             the cut probabilities rounded to bf16, f32 sums
  tri_f32    the same product in f32

The script's draw is sum(u2l[l] for levels l with cdf[l] < u * total).
The cut probabilities are not negative, so those levels are the first
n, up to f32 rounding; the kernel counts them and reads the sum of
u2l's first n levels from u2l's prefix sums, which it takes once
(u2l does not change between draws).  Without a prefix sum (no_cumsum)
the levels are no prefix, and the kernel sums u2l over them.

    python -m fpsc_tpu_torch.probes.probe_draw_tail [b] [iters]

One line per arm: the median us per draw over 9 timed runs.

A column's reductions run on one warp, lane j holding levels 8 j ...
8 j + 7; the elementwise part (tanh, exp) is shared by the column's
`warps` warps (WARPS, the launcher's choice `warps_per_column`), each
of which runs the reductions.  The
plain version repeats the kernel's arithmetic: a prefix sum is each
lane's 8 levels in order, plus the lane's offset from a hypercube scan
of the lane totals, with that scan's column total as level 255's; one
prefix sum of p gives the column sum (level 255) and, in a column where
no level is cut to 0, the cdf (level l's sum less (l + 1) cuts); a
column with a level cut to 0 takes the prefix sum of pcut.  The float
sum of u2l is each lane's 8 levels as a tree, then a butterfly over the
32 lanes.  The product's row l is the sum of levels 0 ... l in order
(the triangle's zeros add nothing), a running sum.
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

SOURCE = "probe_draw_tail.cu"
LEVELS = 256
LANES = 32
PER_LANE = LEVELS // LANES
ARMS = ("empty", "full", "no_cumsum", "no_exp", "no_decode", "no_tanh",
        "tri_bf16", "tri_f32")
# The kernel's template instances: warps a column and the decode of the
# full arm (count and prefix lookup, or the float sum).  The launcher
# takes the first decode and warps_per_column(b); draw_parts times the
# others on the full arm.
WARPS = (1, 2)
DECODES = ("count", "sum")
# warp schedulers an SM
SCHEDULERS = 4
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# An f32 rounding difference of tanh, exp or a sum moves fcpre by an ulp
# or so a draw; no_decode moves fcpre by about 0.1 a draw (cdf[0] - u
# total), so its ulps are larger (1.4e-6 seen at 64 draws on the CPU
# against the script's kernel).  A column that moves by more flipped.
ROUNDING = 2e-6
# `cdf < u * total` is a knife edge: a rounding difference can move one
# level across the threshold, which changes that draw by one u2l entry
# and fcpre by 1e-3 of it, less than FLIP for the script's u2l (|u2l| <
# 5e-3).  At most MAX_FLIP_SHARE of the columns may flip, each by at
# most two flips' worth.
FLIP = 5e-6
MAX_FLIP_SHARE = 1 / 32

# the script's (b, iters)
DEFAULT = (768, 64)


def kernel_name(arm: str) -> str:
    return f"probe_draw_tail_{arm}"


def warps_per_column(b: int, sms: int) -> int:
    """The launcher's warps a column at b columns on a card of `sms` SMs:
    2 while b * 2 warps have a scheduler each, else 1.  (With the
    kernel's tile loads, 4 and 8 warps were at best 1% faster at 8, 100
    and 256 columns on an H100, PERF.md §6.)"""
    return 2 if b * 2 <= SCHEDULERS * sms else 1


def inputs(b: int, device) -> Dict[str, torch.Tensor]:
    """The script's operands, drawn in its order from RandomState(0):
    logits (256, b), u2l (256, b), u (1, b)."""
    rng = np.random.RandomState(0)
    logits = rng.randn(LEVELS, b).astype(np.float32) * .5
    u2l = rng.randn(LEVELS, b).astype(np.float32) * 1e-3
    u = rng.rand(1, b).astype(np.float32)
    return {k: torch.as_tensor(v).to(device)
            for k, v in (("logits", logits), ("u2l", u2l), ("u", u))}


def operands(arm: str, b: int, iters: int, device) -> tuple:
    """The arguments of run(arm, ...) and run_plain(arm, ...) at (b,
    iters)."""
    ops = inputs(b, device)
    return ops["logits"], ops["u2l"], ops["u"], iters


def run(arm: str, logits: torch.Tensor, u2l: torch.Tensor,
        u: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` chained draws of the arm -> fcpre (256, b) f32.  CUDA
    tensors launch the kernel or raise; CPU tensors run `run_plain`."""
    return run_variant(arm, logits, u2l, u, iters)


def run_variant(arm: str, logits: torch.Tensor, u2l: torch.Tensor,
                u: torch.Tensor, iters: int, warps: int = 0,
                decode: str = DECODES[0]) -> torch.Tensor:
    """`run` on one template instance: `warps` of WARPS a column (0: the
    launcher's choice), and for the full arm the other decode of
    DECODES.  CPU tensors run `run_plain` with the decode."""
    if arm not in ARMS:
        raise ValueError(f"probe_draw_tail arms are {ARMS}, not {arm!r}")
    if warps not in (0, *WARPS) or decode not in DECODES:
        raise ValueError(f"probe_draw_tail takes warps in {WARPS} and "
                         f"decode in {DECODES}, not {warps}, {decode!r}")
    changed = decode != DECODES[0]
    if changed and arm != "full":
        raise ValueError(f"{decode!r} is no instance of the {arm} arm")
    dev = operand_device(logits)
    b = logits.shape[-1]
    check_operand("logits", logits, (LEVELS, b), torch.float32, dev)
    check_operand("u2l", u2l, (LEVELS, b), torch.float32, dev)
    check_operand("u", u, (1, b), torch.float32, dev)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, not {iters}")
    if dev.type == "cpu":
        return run_plain(arm, logits, u2l, u, iters, decode)
    out = torch.empty_like(logits)
    p, i = ctypes.c_void_p, ctypes.c_int
    args = (ARMS.index(arm), logits.data_ptr(), u2l.data_ptr(),
            u.data_ptr(), out.data_ptr(), b, iters)
    if warps == 0 and not changed:
        launch(SOURCE, "fpsc_probe_draw_tail", [i, p, p, p, p, i, i],
               kernel_name(arm), dev, *args)
    else:
        launch(SOURCE, "fpsc_probe_draw_tail_variant",
               [i, p, p, p, p, i, i, i, i], kernel_name(arm), dev,
               *args, warps, DECODES.index(decode))
    return out


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(256, b) -> (8, 32, b) as a warp holds it: [i, j] is level 8 j + i,
    register i of lane j."""
    return x.reshape(LANES, PER_LANE, -1).transpose(0, 1)


def _butterfly(s: torch.Tensor) -> torch.Tensor:
    """(32, b) lane values -> (1, b): s += s[lane ^ o], o = 16 ... 1,
    which leaves every lane the same sum."""
    lane = torch.arange(LANES, device=s.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[lane ^ o]
    return s[:1]


def _tree8(c: torch.Tensor) -> torch.Tensor:
    """(8, 32, b) -> (32, b): each lane's 8 levels as a tree ((0 + 1) +
    (2 + 3)) + ((4 + 5) + (6 + 7))."""
    return ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]))


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """The column sums of (256, b) as the kernel's float-sum decode takes
    them: each lane's 8 levels as a tree, then a butterfly over the 32
    lanes."""
    return _butterfly(_tree8(_lanes(x)))


def _scan(x: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sums of (256, b) as the kernel takes them:
    each lane's 8 levels in order; a hypercube scan of the lane totals
    (at k = 1, 2, 4, 8, 16 each lane takes the group total of lane ^ k,
    adds it to its offset if lane & k, and to its own group total),
    which leaves every lane the column total; the lane's offset added to
    each of its sums; and that column total as level 255's."""
    c = _lanes(x)
    sums = [c[0]]
    for i in range(1, PER_LANE):
        sums.append(sums[-1] + c[i])
    lane = torch.arange(LANES, device=x.device)
    total, offset = sums[-1], torch.zeros_like(sums[-1])
    for k in (1, 2, 4, 8, 16):
        other = total[lane ^ k]
        offset = torch.where(((lane & k) != 0)[:, None], offset + other,
                             offset)
        total = total + other
    cdf = torch.stack([offset + s for s in sums])
    cdf[PER_LANE - 1, LANES - 1] = total[LANES - 1]
    return cdf.transpose(0, 1).reshape(LEVELS, -1)


def _prefix(arm: str, pcut: torch.Tensor) -> torch.Tensor:
    if arm == "no_cumsum":
        return pcut
    if arm.startswith("tri_"):
        if arm == "tri_bf16":
            pcut = pcut.to(torch.bfloat16).float()
        rows = [pcut[0]]
        for level in range(1, LEVELS):
            rows.append(rows[-1] + pcut[level])
        return torch.stack(rows)
    return _scan(pcut)


def u2l_prefix(u2l: torch.Tensor) -> torch.Tensor:
    """(257, b): row n is the sum of u2l over levels 0 ... n - 1, by the
    kernel's prefix sum (_scan)."""
    return torch.cat([torch.zeros_like(u2l[:1]), _scan(u2l)])


def draw_plain(arm: str, fcpre: torch.Tensor, u2l: torch.Tensor,
               u: torch.Tensor, decode: str = DECODES[0]) -> torch.Tensor:
    """One draw of the arm -> (1, b).  Decode "count": row n of
    u2l_prefix, n the number of levels with cdf < u * total; "sum" (and
    always without a prefix sum): the column sum of u2l over them."""
    if arm == "no_tanh":
        logits = fcpre * 0.3 + fcpre * 0.2
    else:
        logits = torch.tanh(fcpre) + torch.tanh(fcpre)
    p = logits * 0.125 + 2.0 if arm == "no_exp" else torch.exp(logits * 0.1)
    sums = _scan(p)
    cut = 0.002 * sums[LEVELS - 1:]
    pcut = torch.clamp(p - cut, min=0.0)
    if arm == "no_cumsum" or arm.startswith("tri_"):
        cdf = _prefix(arm, pcut)
    else:
        # where no level of a column is cut to 0, its cdf is the prefix
        # sum of p less (l + 1) cuts; else the prefix sum of pcut
        level = torch.arange(1, LEVELS + 1, device=p.device,
                             dtype=p.dtype)[:, None]
        cdf = torch.where((p < cut).any(0, keepdim=True), _scan(pcut),
                          sums - level * cut)
    thresh = u * cdf[LEVELS - 1:]
    if arm == "no_decode":
        return cdf[:1] - thresh
    below = cdf < thresh
    if decode == "sum" or arm == "no_cumsum":
        return _warp_sum(torch.where(below, u2l, 0.0))
    return u2l_prefix(u2l).gather(0, below.sum(0, keepdim=True))


def run_plain(arm: str, logits: torch.Tensor, u2l: torch.Tensor,
              u: torch.Tensor, iters: int,
              decode: str = DECODES[0]) -> torch.Tensor:
    fcpre = logits
    for _ in range(iters):
        if arm == "empty":
            fcpre = fcpre + 1e-6
        else:
            fcpre = fcpre + draw_plain(arm, fcpre, u2l, u, decode) * 1e-3
    return fcpre


def flips(got: torch.Tensor, want: torch.Tensor) -> int:
    """The columns that moved by more than ROUNDING."""
    diff = (got.detach().cpu() - want.detach().cpu()).abs()
    return int((diff.max(dim=0).values > ROUNDING).sum())


def check(arm: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; raise if more than MAX_FLIP_SHARE of the columns
    (at least one) flipped or any moved by more than two flips."""
    err = float((got.detach().cpu() - want.detach().cpu()).abs().max())
    n = flips(got, want)
    if n > max(1, MAX_FLIP_SHARE * got.shape[-1]) or err > 2 * FLIP:
        raise RuntimeError(f"probe_draw_tail {arm}: {n} of {got.shape[-1]} "
                           f"columns flipped, max |difference| {err:.3g}")
    return err


def ops_per_level(arm: str) -> int:
    """f32 operations a level and draw, each elementary function counted
    as one: the two head terms and their sum (3), the temperature and
    exp (2), the column sum (1), the cut (2), the prefix sum (1, the
    same for the scan and the product: the same function), the compare
    and the u2l sum (2), the update (2).  `empty` is one add."""
    if arm == "empty":
        return 1
    return 13 - (arm == "no_cumsum") - 2 * (arm == "no_decode")


def bound(arm: str, b: int, iters: int) -> Tuple[float, str]:
    """The least time on the card's published peaks -> (ms, by): the
    operands read once and fcpre written once; ops_per_level at the f32
    peak outside the tensor cores.  draw_sass gives the bound the
    kernel's instructions set."""
    ops = float(ops_per_level(arm)) * LEVELS * b * iters
    nbytes = (3 * LEVELS + 1) * b * 4
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# the `kernels` line's bound: the published rates alone, as `bound` is
rate_bound = bound


def main(b: int = DEFAULT[0], iters: int = DEFAULT[1],
         device=None) -> Dict[str, float]:
    """Time every arm on the card and print one line each -> {arm: ms
    of one run of `iters` draws}."""
    dev = resolve_device(device)
    ops = operands(ARMS[0], b, iters, dev)
    name = card(dev)
    times = {}
    for arm in ARMS:
        ms = median_ms(lambda: run(arm, *ops), ops[0])
        print(line(arm, ms * 1e3 / iters, "us/draw", name), flush=True)
        times[arm] = ms
    return times


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
