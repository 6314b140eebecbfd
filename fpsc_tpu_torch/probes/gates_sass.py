"""The instruction bound of the gates probe's kernel, from its SASS.

    python -m fpsc_tpu_torch.probes.gates_sass [b] [iters]

probe_gates.bound counts 12 f32 operations an element and evaluation at
the 67 TFLOP/s f32 rate, each elementary function as one.  The kernel
(csrc/probe_gates.cu, gates_kernel<1>) evaluates expf, tanhf and the
division of sigmoid in full, each several instructions.  This builds
the source, disassembles the library with cuobjdump -sass, takes
gates_kernel<1>'s loop (loop_counts) as its chain of evaluations, and
counts the instructions of its shortest pass (one slot each; a pass
leaves out the calls of a division's slow path, taken only for operands
it cannot handle) and its MUFU instructions; the body holds as many
evaluations as it multiplies by the chain's 0.999 (FMUL by
0x3f7fbe77).  With the card's SM count
and its maximum SM clock (nvidia-smi -q -d CLOCK) it prints

    instruction bound = elements x iters x slots / (SMs x 128 x clock)
    MUFU bound        = elements x iters x MUFU / (SMs x 16 x clock)

(an SM starts an instruction on 128 lanes a clock, a MUFU on 16),
at the probe's default geometry unless given another.  Without a card
or nvcc it raises.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from fpsc_tpu_torch.ops import build
from fpsc_tpu_torch.probes import probe_gates
from fpsc_tpu_torch.probes.timing import card

SOURCE = "probe_gates.cu"
KERNEL = "gates_kernelILi1E"
# the chain's multiplier 0.999f, as cuobjdump prints an f32 immediate
# (in hexadecimal or in decimal)
CHAIN_FACTOR = r"0x3f7fbe77|0\.99900001"
LANES_INSN, LANES_MUFU = 128, 16

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass(library: Path, kernel: str) -> List[Tuple[int, str]]:
    """(address, instruction) of `kernel`'s SASS in the library."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return parse_sass(text, kernel)


def parse_sass(text: str, kernel: str) -> List[Tuple[int, str]]:
    """(address, instruction) of the function whose name holds `kernel`
    in cuobjdump -sass's text; branch targets given as labels become
    addresses."""
    body, inside, labels, pending = [], False, {}, []
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        label = _LABEL.match(line)
        if label:
            pending.append(label.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            body.append((addr, m.group(2)))
    if not body:
        raise RuntimeError(f"no SASS of {kernel}")
    out = []
    for addr, insn in body:
        target = re.search(r"BRA `?\(?(\.L_x_\d+)\)?", insn)
        if target and target.group(1) in labels:
            insn = insn.replace(target.group(1), hex(labels[target.group(1)]))
        out.append((addr, insn))
    return out


_BRA = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def _falls_through(insn: str) -> bool:
    """Whether the next instruction can follow: not after an
    unpredicated BRA, EXIT or RET (BRA.DIV branches only where the warp
    diverged, BRA P, target only where P holds)."""
    op = insn.split()[0]
    return not ((op in ("BRA", "EXIT") or op.startswith("RET"))
                and not re.search(r"\s!?U?P\d,", insn))


def loop_counts(code: List[Tuple[int, str]],
                marker: str = CHAIN_FACTOR) -> Dict[str, object]:
    """The loop: the longest span from a predicated backward branch's
    target to the branch that holds an FMUL by `marker` (an f32
    immediate as cuobjdump prints it; the gates chain's CHAIN_FACTOR by
    default).  An out-of-line block (a shuffle's path for a diverged
    warp) branches back unpredicated, and is no loop.

    Of the loop's body: its instructions; "path", the fewest of them
    that one pass from the first to the backward branch issues, falling
    through or taking a forward branch that lands inside the body (it
    leaves out a division's call of its slow path and, of an if and its
    else, the longer arm: in the draw, the scan of a column with a level
    cut to 0); "skipped_ranges", the (first, last) addresses of the runs
    it leaves out, to be read against the SASS; its MUFU instructions,
    its evaluations (the FMULs by `marker`) and its branches."""
    def evaluates(insn: str) -> bool:
        return bool(re.search(r"\bFMUL\b", insn)
                    and re.search(marker, insn))

    best = None
    for i, (addr, insn) in enumerate(code):
        m = _BRA.search(insn)
        if not m or int(m.group(1), 16) > addr or not insn.startswith("@"):
            continue
        start = int(m.group(1), 16)
        j = next(n for n, (a, _) in enumerate(code) if a == start)
        if any(evaluates(x) for _, x in code[j:i + 1]) and (
                best is None or i - j > best[1] - best[0]):
            best = (j, i)
    if best is None:
        raise RuntimeError(f"no loop around an FMUL by {marker}")
    span = code[best[0]:best[1] + 1]
    body = [insn for _, insn in span]
    index = {a: n for n, (a, _) in enumerate(span)}
    # the fewest instructions from the first to each: every edge but the
    # backward branch runs forward, so one pass in address order
    cost, prev = [None] * len(span), [None] * len(span)
    cost[0] = 1
    for n, insn in enumerate(body[:-1]):
        if cost[n] is None:
            continue
        m = _BRA.search(insn)
        target = index.get(int(m.group(1), 16)) if m else None
        nexts = [n + 1] if _falls_through(insn) else []
        if target is not None and target > n:
            nexts.append(target)
        for k in nexts:
            if cost[k] is None or cost[n] + 1 < cost[k]:
                cost[k], prev[k] = cost[n] + 1, n
    if cost[-1] is None:
        raise RuntimeError("no path through the loop's body")
    on_path, n = set(), len(span) - 1
    while n is not None:
        on_path.add(n)
        n = prev[n]
    ranges = []
    for n, (addr, _) in enumerate(span):
        if n in on_path:
            continue
        if n - 1 in on_path or not ranges:
            ranges.append((addr, addr))
        else:
            ranges[-1] = (ranges[-1][0], addr)
    mufu = [re.search(r"\bMUFU\.\w+", insn) for insn in body]
    return {"instructions": len(body), "path": cost[-1],
            "skipped": len(body) - cost[-1], "skipped_ranges": ranges,
            "mufu": sum(m is not None for m in mufu),
            "evaluations": sum(evaluates(insn) for insn in body),
            "branches": sum(bool(re.search(r"\bBRA\b", insn))
                            for insn in body),
            "mufu_kinds": sorted({m.group(0) for m in mufu if m})}


def skipped_text(counts: Dict[str, object]) -> str:
    """loop_counts' skipped ranges as text: "0x2600-0x2950, ..."."""
    return ", ".join(f"{a:#x}-{b:#x}" for a, b in counts["skipped_ranges"]
                     ) or "none"


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi -q -d CLOCK."""
    text = subprocess.run(["nvidia-smi", "-q", "-d", "CLOCK"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout
    section = text[text.index("Max Clocks"):]
    return float(re.search(r"SM\s*:\s*(\d+) MHz", section).group(1)) * 1e6


def main(b: int = probe_gates.DEFAULT[0], iters: int = probe_gates.DEFAULT[1]
         ) -> Dict[str, float]:
    """Print the loop's counts and the bounds they set -> a dict of them."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the SASS and the clock are the "
                           "card's")
    name = card(torch.device("cuda"))
    library = build.build([SOURCE])[SOURCE]
    counts = loop_counts(sass(library, KERNEL))
    evals = counts["evaluations"]
    if evals < 1:
        raise RuntimeError(f"no FMUL by {CHAIN_FACTOR} in the loop: {counts}")
    slots = counts["path"] / evals
    mufu = counts["mufu"] / evals
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    elements = probe_gates.H * b
    insn_ms = elements * iters * slots / (sms * LANES_INSN * clock) * 1e3
    mufu_ms = elements * iters * mufu / (sms * LANES_MUFU * clock) * 1e3
    flop_ms = probe_gates.bound("gates_f32", b, iters)[0]
    print(f"gates_kernel<1> loop: {counts['instructions']} instructions, "
          f"{counts['skipped']} of them off its shortest pass "
          f"({skipped_text(counts)}), "
          f"{counts['mufu']} MUFU ({', '.join(counts['mufu_kinds'])}), "
          f"{counts['branches']} branches, {evals} evaluations: "
          f"{slots:.2f} instruction slots and {mufu:.2f} MUFU an element "
          f"and evaluation [{name}]")
    print(f"{sms} SMs, max SM clock {clock / 1e6:.0f} MHz; {elements} "
          f"elements x {iters} evaluations: instruction bound "
          f"{insn_ms:.5f} ms, MUFU bound {mufu_ms:.5f} ms; the f32-rate bound "
          f"probe_gates.bound counts {flop_ms:.5f} ms [{name}]")
    return {"slots": slots, "mufu": mufu, "insn_ms": insn_ms,
            "mufu_ms": mufu_ms, "clock_hz": clock, "sms": sms}


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
