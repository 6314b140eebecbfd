"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json, at the root of
the checkout: it names a configuration (whose file lies under
benchmark/configs/) and a traffic mix (benchmark/traffic/<traffic>.json,
which names the driver under benchmark/drivers/ and holds its
parameters).  The driver sets the program up from the seed, warms it up
on the cell's shapes, measures for --seconds seconds, and decides
`correct` against the plain reference under benchmark/reference/ with
the limits of benchmark/limits/<cell>.json.  With --trace 0 the result
holds the cell's end-to-end metrics, with --trace 1 its per-layer ones,
each computed by a reader of its own (benchmark/e2e_metrics/<name>.py,
benchmark/layer_metrics/<name>.py).

The last line of standard output is one JSON object: correct,
attempted, failed, metrics, device, with --trace 1 a breakdown, and
last the numbers compared, each with its limit; the same numbers are
the last lines of standard error.  Without a CUDA card, with fewer cards
than the cell asks for, or where the run ends holding JAX or the JAX
package, it prints no result and exits with 2; on an error, with 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Build and kernel caches at fixed paths inside the checkout: only the
# first run of a checkout builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def cell_spec(name: str):
    """(the cell, its configuration, its traffic, the metrics of
    BENCHMARK.json that the cell reports: end-to-end, per-layer)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return (cell, config, traffic, mine(spec["end_to_end"]),
            mine(spec["per_layer"]))


def reader(folder: str, metric: str):
    path = BENCH / folder / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, e2e, layers = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA card(s), "
            f"this process sees {torch.cuda.device_count()}")
        return 2
    from benchmark.core import guard
    from benchmark.core.record import Record

    limits = json.loads(
        (BENCH / "limits" / f"{args.workload}.json").read_text())
    rec = Record(cell, config, traffic, bool(args.trace))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    work = tempfile.mkdtemp(prefix="fpsc_bench_")
    try:
        driver.run(rec, seed=args.seed, seconds=args.seconds, work=work,
                   limits=limits, t_start=T0, log=log)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    held = guard.loaded()
    if held:
        log(f"no result: the run holds {held}")
        return 2
    metrics = {}
    folder, wanted = (("layer_metrics", layers) if args.trace
                      else ("e2e_metrics", e2e))
    for m in wanted:
        value = reader(folder, m["name"])(rec)
        if value is None:
            if not args.trace:
                raise RuntimeError(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": rec.failed == 0 and all(c.ok for c in rec.checks),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = sum(t.busy_s for t in rec.traces)
        device["window_s"] = sum(t.window_s for t in rec.traces)
        if rec.traces:
            out["breakdown"] = rec.traces[0].breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in rec.checks}
    for c in rec.checks:
        log(c.line())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
