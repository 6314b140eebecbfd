"""The tick runner of the streaming classes: the port's counterpart of
each `jax.jit(tick)` of fpsc_tpu/codec/streaming.py.

A JAX streaming class compiles its tick once (one XLA program per batch
shape) and calls it every 10 ms with the state passed in and returned.
Here a class allocates its state and its input buffers once, as static
tensors, and hands a pure tick function to a `TickRunner`:

    tick(*states, *inputs) -> (new states, packed output row)

On the card the runner captures the tick once
(`utils.device.captured`: an eager warm-up, then the capture, under
`no_tf32`) as a CUDA graph that computes the new states into
temporaries and copies them into the static state buffers at its end;
the warm-up's tick advances the states, so the runner zeroes them after
it.  Each call copies its inputs from pinned host buffers into the
static inputs, replays the graph, and copies the packed row back to a
pinned host buffer, waited for by one event: the one host transfer of a
tick, as the JAX classes pull a single array.

A capture that fails raises; nothing falls back to running the tick
eagerly.  A tick must not synchronise with the host (no `.item()`,
`.cpu()`, `bool(tensor)`, boolean-mask indexing, `nonzero` or a numpy
round trip): the capture refuses it.  Inside `utils.device.eager()` the
runner captures nothing and ticks eagerly on the card, for comparison
with the graph and for counting its launches; on the CPU the tick
always runs eagerly, with the same functions.

`reset()` zeroes the state buffers in place: the graph holds their
addresses, so they are never reallocated.

A tick runs only through `call(stage, unpack)`, from a class's public
tick method, which records it as spans (utils/logging.py): a root
`tick` (the class and batch its owner gave the runner, whether a graph
replays) over `tick.stage` (the caller writes its inputs into the
staged buffers), `tick.launch` (the copies in, the replay or the eager
tick, the copy out and the event's record; on the CPU the eager tick),
`tick.wait` (the event's synchronize; not on the CPU) and `tick.unpack`
(the row's copy and its split into the caller's result).  The capture
is the span `tick.capture`.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from fpsc_tpu_torch.utils.device import captured, no_tf32
from fpsc_tpu_torch.utils.logging import span


class TickRunner:
    """One tick function over static state and input tensors (all on one
    device): eager on the CPU, a replayed CUDA graph on the card."""

    def __init__(self, tick: Callable, states: Sequence[torch.Tensor],
                 inputs: Sequence[torch.Tensor], *, owner: str, batch: int):
        self.tick = tick
        self.owner, self.batch = owner, batch
        self.states: List[torch.Tensor] = list(states)
        self.inputs: List[torch.Tensor] = list(inputs)
        self.device = self.inputs[0].device
        cuda = self.device.type == "cuda"
        # the host side of each input: pinned twins on the card, the
        # static buffers themselves on the CPU
        self.hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                      if cuda else x for x in self.inputs]
        self.stage = [h.numpy() for h in self.hosts]
        self.graph = None
        self.capture_s = 0.0
        self._out = self._host_out = None
        if cuda:
            self._done = torch.cuda.Event()
            s = span("tick.capture", cls=owner, batch=batch)
            self.graph = captured(self._advance, self.device, s)
            self.capture_s = s.seconds
            if self.graph is not None:
                self.reset()            # the warm-up's tick advanced them

    def _advance(self) -> torch.Tensor:
        """The tick on the static buffers: the new states copied into the
        state buffers, the output row kept as `_out` and returned.  The
        new states are fresh tensors (or views of the inputs), so
        copying them in turn reads no value already overwritten."""
        new, self._out = self.tick(*self.states, *self.inputs)
        for s, n in zip(self.states, new):
            s.copy_(n)
        return self._out

    def reset(self):
        for s in self.states:
            s.zero_()

    def call(self, stage: Callable[[], None],
             unpack: Callable[[np.ndarray], object]):
        """One tick of a class's public method: `stage()` writes the
        inputs into `stage[i]`, the runner ticks, and `unpack(row)` turns
        a copy of the output row into the result, each as a span under a
        root `tick`."""
        with span("tick", cls=self.owner, batch=self.batch,
                  graph=self.graph is not None):
            with span("tick.stage"):
                stage()
            row = self._row()
            with span("tick.unpack"):
                return unpack(row.copy())

    def _row(self) -> np.ndarray:
        """One tick -> the output row, which the next tick may
        overwrite."""
        if self.device.type != "cuda":
            with span("tick.launch"), torch.no_grad():
                return self._advance().numpy()
        with span("tick.launch"):
            for x, h in zip(self.inputs, self.hosts):
                x.copy_(h, non_blocking=True)
            if self.graph is not None:
                self.graph.replay()
            else:
                with torch.no_grad(), no_tf32():
                    self._advance()
            if self._host_out is None:
                self._host_out = torch.empty(
                    self._out.shape, dtype=self._out.dtype, pin_memory=True)
            self._host_out.copy_(self._out, non_blocking=True)
            self._done.record()
        with span("tick.wait"):
            self._done.synchronize()
        return self._host_out.numpy()
