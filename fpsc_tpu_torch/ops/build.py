"""Build the hand-written CUDA kernels and count their launches.

Each source under fpsc_tpu_torch/csrc/ is compiled by nvcc, at first
use, into a shared library with a plain C interface, which is loaded
with ctypes.  Libraries go to build/kernels/ at the repo root, named by
a hash of the source and the flags, so an edited source is rebuilt.
`build()` starts one nvcc per source, all together.  Nothing here runs
at import time: the CPU tests import every module.

Every kernel wrapper adds one to `launch_counts[name]` where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

launch_counts: Dict[str, int] = {}
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> List[str]:
    """Every CUDA source of the port."""
    return sorted(p.name for p in CSRC.glob("*.cu"))


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes
    at once; raise with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    procs = {}
    for s, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[s] = log
        if proc.returncode != 0:
            failed.append(f"{s} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build([source])[source]))
    return _libs[source]
