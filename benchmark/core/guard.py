"""The modules a run must not hold: JAX and the JAX package.  Names are
compared by their whole top-level part (before the first dot), so the
port, whose name begins with the JAX package's, is not caught."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fpsc_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if top(n) in FORBIDDEN})


def loaded() -> List[str]:
    """The forbidden modules this process holds."""
    return forbidden(list(sys.modules))
