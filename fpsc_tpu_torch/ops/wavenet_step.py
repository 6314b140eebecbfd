"""The WaveNet's sample steps as one hand-written CUDA kernel a chunk.

`chunk` runs K = `StepShape.chunk` sample steps of generation from the
state that models/wavenet.py::GenerateChunks carries in its static
buffers (`StepOperands`): on CUDA tensors one launch of the kernel of
csrc/wavenet_step.cu (a thread-block cluster of 16 CTAs a group of 12
rows, the layers' weight columns streamed through shared memory, each
phase's output exchanged through distributed shared memory; the source's
note says why), then the position advanced by K; `pack` lays the layers'
weights out as the kernel's CTAs read them; on CPU tensors the plain
version the caller gives (GenerateChunks._plain_chunk), with the same
arithmetic.  It never falls back from the card to the CPU: a CUDA tensor
launches the kernel or raises, and widths the kernel's tiling does not
divide, or whose layers do not fit a CTA's shared memory, are refused on
the card with an error that names them.

Each launch adds one to `build.launch_counts[KERNEL]`; under a stream
capture that counts the capture, not the graph's replays.  The library
is built by ops/build.py at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from fpsc_tpu_torch.dsp import constants as C
from fpsc_tpu_torch.ops import build

SOURCE = "wavenet_step.cu"
# launch counter of the kernel
KERNEL = "wavenet_step"
# CTAs a cluster, the most layers and the dynamic shared memory a CTA may
# take: the .cu's kCluster, kMaxLayers and kMaxSmem
CLUSTER = 16
MAX_LAYERS = 64
SMEM_BYTES = 232448
OUT_CHANNELS = 2


class StepOperands(NamedTuple):
    """GenerateChunks' buffers, float32 (`pos` int64), contiguous, on
    one device: the layers' weights as `pack` lays them out (n, 16,
    `packed_floats`); the front (K, rc) and (rc,); final1 (sc, sc) and
    (sc,), final2 (sc, 2) and (2,); the
    projected conditioning (n, block, rows, 2 gc); the chunk's eps (K,
    rows) and LPC (K, rows, 16); the rings (sum of d + 1, rows, rc); the
    history x (lead + K, rows); the output y (K + 1, rows); the position
    ()."""
    packed: torch.Tensor
    front_w: torch.Tensor
    front_b: torch.Tensor
    f1_w: torch.Tensor
    f1_b: torch.Tensor
    f2_w: torch.Tensor
    f2_b: torch.Tensor
    cond: torch.Tensor
    eps: torch.Tensor
    lpc: torch.Tensor
    rings: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    pos: torch.Tensor


@dataclass(frozen=True)
class StepShape:
    rows: int
    residual: int
    gate: int
    skip: int
    out: int
    front_kernel: int
    lead: int
    chunk: int
    cond_block: int
    dilations: Tuple[int, ...]
    deemphasis: float

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each operand's shape."""
        n, rows, k = len(self.dilations), self.rows, self.chunk
        rc, gc, sc = self.residual, self.gate, self.skip
        return {
            "packed": (n, CLUSTER, packed_floats(self)),
            "front_w": (self.front_kernel, rc), "front_b": (rc,),
            "f1_w": (sc, sc), "f1_b": (sc,),
            "f2_w": (sc, self.out), "f2_b": (self.out,),
            "cond": (n, self.cond_block, rows, 2 * gc), "eps": (k, rows),
            "lpc": (k, rows, C.LPC_ORDER),
            "rings": (sum(d + 1 for d in self.dilations), rows, rc),
            "x": (self.lead + k, rows), "y": (k + 1, rows), "pos": ()}


def refused(shape: StepShape) -> List[str]:
    """Why the kernel's tiling does not take these widths (nothing where
    it does): each CTA of a cluster takes a multiple of 4 of the gate,
    residual and skip channels, two float4 groups of the residual and
    skip columns and of final1's, and every product's depth is a
    multiple of the warp's 32 lanes."""
    rc, gc, sc, c = shape.residual, shape.gate, shape.skip, CLUSTER
    why = []
    if rc % (4 * c) or rc % 32:
        why.append(f"wavenet.residual_channels={rc} (a multiple of "
                   f"{4 * c} and 32)")
    if gc % (4 * c) or gc % 32:
        why.append(f"wavenet.gate_channels={gc} (a multiple of {4 * c} "
                   f"and 32)")
    if sc % (8 * c) or sc % 32:
        why.append(f"wavenet.skip_channels={sc} (a multiple of {8 * c})")
    if (rc + sc) % (8 * c):
        why.append(f"wavenet.residual_channels + skip_channels={rc + sc} "
                   f"(a multiple of {8 * c})")
    if shape.out != OUT_CHANNELS:
        why.append(f"wavenet.out_channels={shape.out} (mean and log_std: "
                   f"{OUT_CHANNELS})")
    if not 1 <= len(shape.dilations) <= MAX_LAYERS:
        why.append(f"{len(shape.dilations)} layers (1 to {MAX_LAYERS})")
    if any(d < 1 for d in shape.dilations):
        why.append(f"dilations {shape.dilations} (each at least 1)")
    if shape.front_kernel < 1 or shape.lead < max(shape.front_kernel,
                                                   C.LPC_ORDER):
        why.append(f"wavenet.front_kernel={shape.front_kernel} with a "
                   f"history of {shape.lead}")
    if shape.rows < 1 or shape.chunk < 1 or shape.cond_block < 1:
        why.append(f"rows={shape.rows}, chunk={shape.chunk}, "
                   f"cond_block={shape.cond_block} (each at least 1)")
    return why


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def _pad_ld(cols: int) -> int:
    return cols + 4 if (cols // 4) % 2 == 0 else cols


def _columns(shape: StepShape):
    """Per CTA j: its gate channels' filter then gate columns of the taps
    (16, 2 G), and its residual then skip columns of the residual and
    skip product (16, rb + sb)."""
    c, rc, gc, sc = CLUSTER, shape.residual, shape.gate, shape.skip
    g, rb, sb = gc // c, rc // c, sc // c
    j = torch.arange(c)[:, None]
    taps = torch.cat([j * g + torch.arange(g), gc + j * g + torch.arange(g)],
                     1)
    rs = torch.cat([j * rb + torch.arange(rb), rc + j * sb + torch.arange(sb)],
                   1)
    return taps, rs


def packed_floats(shape: StepShape) -> int:
    """Floats of a CTA's block of a layer's packed weights as `pack` lays
    them out (on the card `check` holds the kernel's own reckoning,
    fpsc_wavenet_step_packed, to it)."""
    c, rc, gc, sc = CLUSTER, shape.residual, shape.gate, shape.skip
    g, rb, sb = gc // c, rc // c, sc // c
    return (2 * rc * _pad_ld(2 * g) + gc * _pad_ld(rb + sb) + _up4(2 * g)
            + _up4(rb + sb))


def pack(past: torch.Tensor, now: torch.Tensor, conv_b: torch.Tensor,
         rs: torch.Tensor, rs_b: torch.Tensor, shape: StepShape,
         out: torch.Tensor) -> None:
    """The layers' step weights (models/wavenet.py::_step_weights stacked:
    past and now (n, rc, 2 gc), conv_b (n, 2 gc), rs (n, gc, rc + sc),
    rs_b (n, rc + sc)) into out (n, 16, `packed_floats`), CTA j's block of
    layer i as the kernel's stage holds it: the taps' rows (h[t - d]'s,
    then h[t]'s) of its filter and gate columns, padded to the kernel's
    row stride; the residual and skip product's rows of its columns,
    padded; their biases, padded to a float4."""
    c, n = CLUSTER, past.shape[0]
    taps, rsc = (x.to(past.device) for x in _columns(shape))

    def padded(x, width):
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))

    a = torch.cat([past, now], 1)[:, :, taps].permute(0, 2, 1, 3)
    b = rs[:, :, rsc].permute(0, 2, 1, 3)
    out.copy_(torch.cat([
        padded(a, _pad_ld(taps.shape[1])).reshape(n, c, -1),
        padded(b, _pad_ld(rsc.shape[1])).reshape(n, c, -1),
        padded(conv_b[:, taps], _up4(taps.shape[1])),
        padded(rs_b[:, rsc], _up4(rsc.shape[1]))], 2))


def check(ops: StepOperands, shape: StepShape) -> None:
    """Raise ValueError where the kernel cannot take the operands: widths
    its tiling refuses (named), more than one device, a dtype other than
    float32 (int64 for pos), a shape other than `shape`'s, or an operand
    not contiguous; on the card also widths whose CTA's shared memory,
    as the kernel reckons it, is above the card's (named)."""
    why = refused(shape)
    if why:
        raise ValueError("the WaveNet step kernel does not take "
                         + "; ".join(why))
    devices = {t.device for t in ops}
    if len(devices) != 1:
        raise ValueError(f"the WaveNet step's operands lie on "
                         f"{sorted(map(str, devices))}, not one device")
    want = shape.shapes()
    for name, t in zip(StepOperands._fields, ops):
        dtype = torch.int64 if name == "pos" else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"WaveNet step operand {name} is {t.dtype}, "
                             f"not {dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"WaveNet step operand {name} has shape "
                             f"{tuple(t.shape)}, not {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"WaveNet step operand {name} is not "
                             f"contiguous")
    if ops.x.device.type != "cuda":
        return
    smem = smem_bytes(shape)
    if smem > SMEM_BYTES:
        raise ValueError(
            f"the WaveNet step kernel does not take widths "
            f"{shape.residual}/{shape.gate}/{shape.skip}, front "
            f"{shape.front_kernel}, chunk {shape.chunk}: {smem} bytes of "
            f"shared memory a CTA, above {SMEM_BYTES}")
    block = _library().fpsc_wavenet_step_packed(shape.residual, shape.gate,
                                         shape.skip)
    if block != packed_floats(shape):
        raise RuntimeError(f"{KERNEL}: the kernel reads a packed block of "
                           f"{block} floats, pack writes "
                           f"{packed_floats(shape)}")


def _library():
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    if lib.fpsc_wavenet_step.argtypes is None:
        # 10 operands read, rings, x, y, pos; 9 sizes, the dilations,
        # deemphasis, stream
        lib.fpsc_wavenet_step.argtypes = ([p] * 14 + [i] * 9 + [p]
                                          + [ctypes.c_float, p])
        lib.fpsc_wavenet_step.restype = i
        lib.fpsc_wavenet_step_smem.argtypes = [i] * 6
        lib.fpsc_wavenet_step_smem.restype = i
        lib.fpsc_wavenet_step_packed.argtypes = [i] * 3
        lib.fpsc_wavenet_step_packed.restype = i
    return lib


def _size_args(shape: StepShape) -> Tuple[int, ...]:
    return (shape.residual, shape.gate, shape.skip, shape.front_kernel,
            shape.lead, shape.chunk)


def smem_bytes(shape: StepShape) -> int:
    """The dynamic shared memory a CTA takes at these widths, as the
    kernel reckons it (the library is built: on the card's machine)."""
    return _library().fpsc_wavenet_step_smem(*_size_args(shape))


def chunk(ops: StepOperands, shape: StepShape,
          plain: Callable[[], None]) -> None:
    """K sample steps from the carried state, in place: y[1:] the
    de-emphasised samples, y[0], x, the rings and pos carried on.  CUDA
    tensors: the kernel, then pos += K (refused widths, or a launch the
    card refuses, raise).  CPU tensors: `plain()`."""
    dev = ops.x.device
    if dev.type == "cpu":
        plain()
        return
    if dev.type != "cuda":
        raise ValueError(f"the WaveNet step runs on cuda or cpu, not {dev}")
    check(ops, shape)
    lib = _library()
    dil = (ctypes.c_int * len(shape.dilations))(*shape.dilations)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.count_launch(KERNEL)
        err = lib.fpsc_wavenet_step(
            *[t.data_ptr() for t in ops], shape.rows, shape.residual,
            shape.gate, shape.skip, shape.front_kernel, shape.lead,
            shape.chunk, shape.cond_block, len(shape.dilations), dil,
            shape.deemphasis, stream)
        if err != 0:
            raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA "
                               f"error {err}")
        ops.pos.add_(shape.chunk)
