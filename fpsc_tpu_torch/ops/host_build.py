"""Build the port's host C++ libraries with g++ and load them.

The sources under fpsc_tpu_torch/csrc/ with a `.cpp` suffix are host
code (no CUDA): the range coder's runtime and the feature extractor.  Each is compiled at first
use with the flags below into build/host/ at the repo root, named by a
hash of the source and the flags, so an edited source is rebuilt.  Test
workers may build the same library at once: each compiles to a name of
its own (with its pid) and publishes with os.replace, which is atomic,
so no process loads a half-written library.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HOST_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-pthread", "-shared")

build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host libraries cannot be "
                           "built")
    return found


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return HOST_DIR / f"{src.stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """The library of one source, compiled first if it is missing; raise
    with g++'s output if the build fails."""
    path = library_path(source)
    if path.exists():
        return path
    HOST_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run([gxx(), *GXX_FLAGS, "-o", str(tmp),
                          str(CSRC / source)],
                         capture_output=True, text=True)
    build_logs[source] = run.stdout + run.stderr
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {source} failed (g++ exit "
                           f"{run.returncode}):\n{build_logs[source]}")
    os.replace(tmp, path)
    return path


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    if source not in _libs:
        _libs[source] = ctypes.CDLL(str(build(source)))
    return _libs[source]
