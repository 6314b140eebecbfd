"""The harness's refusals and the modules a run may hold."""
import json
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT
from benchmark.core import guard


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "b2_bulk_decode", "--seed", str(2 ** 31 + 1),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_guard_compares_whole_top_level_names():
    names = ["fpsc_tpu_torch.codec.cli", "fpsc_tpu.ops", "jax", "jaxlib.xla",
             "flax.linen", "jaxtyping", "fpsc_tpu_tools", "torch"]
    assert guard.forbidden(names) == ["flax.linen", "fpsc_tpu.ops", "jax",
                                      "jaxlib.xla"]


def test_reference_loads_nothing_of_the_program():
    p = _run("import sys; sys.path.insert(0, '.')\n"
             "import benchmark.reference.decode, benchmark.reference.live\n"
             "import benchmark.reference.frontend, benchmark.reference.dsp\n"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    tops = json.loads(p.stdout.replace("'", '"'))
    assert "fpsc_tpu_torch" not in tops and "fpsc_tpu" not in tops
    assert "jax" not in tops


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole decode run and a live run on the program's CPU path, and
    every reader, in one process: no module of top-level name jax,
    jaxlib, flax or fpsc_tpu."""
    code = f"""
import sys, json, glob, os
sys.path.insert(0, '.'); sys.path.insert(0, 'benchmark/tests')
from bench_helpers import drive, tiny_decode, tiny_live, load
from benchmark.drivers import decode, live
from benchmark import run
drive(decode, load('configs/lpcnet_b2_sparse.json'), tiny_decode(),
      load('limits/b2_bulk_decode.json'), tmp={str(tmp_path)!r})
drive(live, load('configs/lpcnet_b1.json'), tiny_live(),
      load('limits/b1_live_calls.json'), tmp={str(tmp_path)!r})
for folder in ('e2e_metrics', 'layer_metrics'):
    for f in glob.glob(f'benchmark/{{folder}}/*.py'):
        run.reader(folder, os.path.basename(f)[:-3])
from benchmark.core import guard
print(json.dumps(guard.loaded()))
print(json.dumps('fpsc_tpu_torch' in sys.modules))
"""
    p = _run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    held, port = [json.loads(x) for x in p.stdout.strip().splitlines()[-2:]]
    assert held == []
    assert port          # the program under test was loaded


def test_every_metric_has_its_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"]:
        assert (BENCH / "e2e_metrics" / f"{m['name']}.py").exists()
    for m in spec["per_layer"]:
        assert (BENCH / "layer_metrics" / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
