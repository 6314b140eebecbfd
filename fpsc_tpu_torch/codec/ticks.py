"""The tick runner of the streaming classes: the port's counterpart of
each `jax.jit(tick)` of fpsc_tpu/codec/streaming.py.

A JAX streaming class compiles its tick once (one XLA program per batch
shape) and calls it every 10 ms with the state passed in and returned.
Here a class allocates its state and its input buffers once, as static
tensors, and hands a pure tick function to a `TickRunner`:

    tick(*states, *inputs) -> (new states, packed output row)

On the card the runner runs the tick once eagerly on a side stream (a
warm-up whose results are dropped: it makes the libraries' handles, the
cuFFT plans and the constant tables of dsp/, so that nothing is copied
from the host during the capture), then captures it once as a
`torch.cuda.CUDAGraph` that computes the new states into temporaries and
copies them into the static state buffers at its end.  Each call copies
its inputs from pinned host buffers into the static inputs, replays the
graph, and copies the packed row back to a pinned host buffer, waited
for by one event: the one host transfer of a tick, as the JAX classes
pull a single array.  The graph is captured with TF32 off
(`utils.device.no_tf32`): the flags are read when a product is
captured, not when it is replayed.

A capture that fails raises; nothing falls back to running the tick
eagerly.  A tick must not synchronise with the host (no `.item()`,
`.cpu()`, `bool(tensor)`, boolean-mask indexing, `nonzero` or a numpy
round trip): the capture refuses it.  `graph=False` asks for the eager
tick on the card, for comparison with the graph and for counting its
launches; on the CPU the tick always runs eagerly, with the same
functions.

`reset()` zeroes the state buffers in place: the graph holds their
addresses, so they are never reallocated.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence

import numpy as np
import torch

from fpsc_tpu_torch.utils.device import no_tf32


class TickRunner:
    """One tick function over static state and input tensors (all on one
    device): eager on the CPU, a replayed CUDA graph on the card."""

    def __init__(self, tick: Callable, states: Sequence[torch.Tensor],
                 inputs: Sequence[torch.Tensor], graph: bool = True):
        self.tick = tick
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
            if graph:
                self._capture()

    def _step(self):
        """The tick on the static buffers -> (new states, output row).
        The new states are fresh tensors (or views of the inputs), so
        copying them into the state buffers in turn reads no value
        already overwritten."""
        return self.tick(*self.states, *self.inputs)

    def _advance(self):
        new, out = self._step()
        for s, n in zip(self.states, new):
            s.copy_(n)
        return out

    def _capture(self):
        t0 = time.perf_counter()
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), no_tf32():
            with torch.cuda.stream(side):
                self._step()                    # warm-up, results dropped
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = self._advance()
        torch.cuda.synchronize(dev)
        self._out = out
        self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def reset(self):
        for s in self.states:
            s.zero_()

    def run(self) -> np.ndarray:
        """One tick on the staged inputs (`stage[i]`, written by the
        caller) -> the packed output row, a host array of its own."""
        if self.device.type != "cuda":
            with torch.no_grad():
                return self._advance().numpy().copy()
        for x, h in zip(self.inputs, self.hosts):
            x.copy_(h, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            out = self._out
        else:
            with torch.no_grad(), no_tf32():
                out = self._advance()
            if self._host_out is None:
                self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                             pin_memory=True)
        self._host_out.copy_(out, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return self._host_out.numpy().copy()
