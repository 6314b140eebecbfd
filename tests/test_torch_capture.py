"""The one capture of the port's replayed loops (utils/device.py::captured)
and the one switch back to their eager steps (`eager()`), on the CPU.

The captures themselves are the card's (tests/test_torch_card.py,
tests/test_torch_trace.py); here: the scope nests, restores its setting
and keeps `replays` false inside it; inside it the helper runs nothing
and records nothing; the helper refuses a device other than the card; and no
module of the port but utils/device.py captures a graph.  Nothing here
loads JAX.
"""
import contextlib
import pathlib
import re

import pytest
import torch

from fpsc_tpu_torch.utils import device as udev
from fpsc_tpu_torch.utils import logging as log

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "fpsc_tpu_torch"
CAPTURES = re.compile(r"torch\.cuda\.graph\(|CUDAGraph\(")


def test_the_eager_scope_nests_and_restores(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    card = torch.device("cuda")
    with torch.no_grad():
        assert udev.replays(card)
        with udev.eager():
            assert not udev.replays(card)
            with udev.eager():
                assert not udev.replays(card)
            assert not udev.replays(card)
        assert udev.replays(card)
        with pytest.raises(KeyError):
            with udev.eager():
                raise KeyError("left by an exception")
        assert udev.replays(card)


def test_inside_the_eager_scope_nothing_is_captured_or_recorded():
    ran = []
    log.clear_spans()
    with udev.eager():
        got = udev.captured(lambda: ran.append(1), torch.device("cuda"),
                            log.span("predictor.capture", batch=1, chunk=16))
    assert got is None and ran == []
    assert [s.name for s in log.spans()] == []


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
def test_the_helper_refuses_a_cpu_device(inside):
    ran = []
    with udev.eager() if inside else contextlib.nullcontext():
        with pytest.raises(ValueError, match="cpu"):
            udev.captured(lambda: ran.append(1), torch.device("cpu"))
    assert ran == []


def test_only_the_helper_captures_a_graph():
    """The next replayed loop of the port goes through `captured`."""
    found = {str(p.relative_to(PACKAGE)): len(CAPTURES.findall(
        p.read_text())) for p in PACKAGE.rglob("*.py")}
    assert found.pop("utils/device.py") == 2
    assert {p: n for p, n in found.items() if n} == {}
