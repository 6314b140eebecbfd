"""Readings that the limits of `correct` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, one run of the cell (a short window at the cell's own
load and sizes) whose judge also reads the control: the reference in
the precision below the configuration's, put in the program's place.
One JSON line a seed: the program's numbers (the lower readings) and
the control's (the upper ones).  The benchmark's own runs do not run
the control.
"""
from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell, config, traffic, _, _ = bench.cell_spec(args.workload)
    from benchmark.core.record import Record
    limits = json.loads((bench.BENCH / "limits"
                         / f"{args.workload}.json").read_text())
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    for seed in args.seeds:
        rec = Record(cell, config, traffic, False)
        work = tempfile.mkdtemp(prefix="fpsc_calib_")
        t0 = time.perf_counter()
        try:
            driver.run(rec, seed=seed, seconds=args.seconds, work=work,
                       limits=limits, t_start=t0, log=bench.log,
                       control=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {**{c.name: c.value for c in rec.checks},
                        **(rec.lists.get("program") or [{}])[0]},
            "control": rec.lists.get("control"),
            "attempted": rec.attempted, "failed": rec.failed,
            "setup_s": rec.setup_s,
            "wall_s": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
