"""Device selection for the port's entry points, and the capture of its
replayed loops.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, as the tests do).  Without a card and without that
request they raise: nothing carries on silently on the CPU.

Every loop the port replays as a CUDA graph on the card is captured by
`captured`; inside `eager()` each runs its step eagerly instead.
Launches that run together, each on its own stream, take their streams
from `side_streams`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from fpsc_tpu_torch.utils.logging import span


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def split_device_arg(argv: List[str]) -> Tuple[List[str], Optional[str]]:
    """An entry point's arguments without `--device=...`, and that
    device (None when not given: the card)."""
    device = None
    rest = []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


# (id of the numpy table, device) -> (the table, its float32 tensor)
_CONSTANTS: Dict[Tuple[int, torch.device], Tuple[np.ndarray, torch.Tensor]] = {}


def device_constant(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The float32 tensor of a module-level numpy table on `device`, made
    once per table and device and kept.  A copy from pageable host
    memory is refused while a CUDA stream is capturing a graph, so a
    function that a graph captures (the streaming ticks) must find its
    tables already on the card: the eager warm-up before the capture
    makes them.  The entry holds the table, so its id stays its own."""
    key = (id(a), torch.device(device))
    hit = _CONSTANTS.get(key)
    if hit is None or hit[0] is not a:
        hit = _CONSTANTS[key] = (a, torch.as_tensor(
            a, dtype=torch.float32, device=device))
    return hit[1]


def host_array(x) -> np.ndarray:
    """x as a numpy array on the host: a tensor on any device, or an
    array."""
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's intra-op thread count set to n inside the block, and
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN's convolutions and for CUDA float32 matmuls
    inside the block, both settings restored after it.  PyTorch's
    default lets cuDNN round a float32 convolution's inputs to TF32 (about
    three decimal digits); the port's float32 arithmetic is full
    float32, as the reference's."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def no_cudnn():
    """cuDNN off inside the block (PyTorch's own CUDA kernels instead),
    the setting restored after it."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def replays(device: torch.device) -> bool:
    """Whether a model's chunked loop (frame_predictor.DecodeChunks,
    wavenet.GenerateChunks) replays a captured graph for operands on
    `device`: on the card, with grad mode off, outside `eager()` and
    with no stream capture under way on the current stream."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and not _eager.depth
            and not torch.cuda.is_current_stream_capturing())


class _Eager(threading.local):
    depth = 0           # the calling thread's open `eager()` blocks


_eager = _Eager()


@contextlib.contextmanager
def eager():
    """Inside the block (of the calling thread; blocks nest) `captured`
    captures nothing and `replays` is false, so every replayed loop of
    the port runs its step eagerly on the card: the reference its graph
    is held to."""
    depth = _eager.depth
    _eager.depth = depth + 1
    try:
        yield
    finally:
        _eager.depth = depth


# device -> the one side stream of every capture on it: cuBLAS keeps a
# workspace for each stream it has run on, so a new stream a capture
# would hold one more workspace each time
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


# device -> the side streams on which launches that run together go out
# (codec/cli.py's sampler launches of a group of buckets), made at first
# use and kept: the pool grows to the widest group a process has run
_SIDE_STREAMS: Dict[torch.device, List["torch.cuda.Stream"]] = {}


def _card(device: torch.device) -> torch.device:
    """The card `device` names, with its index."""
    device = torch.device(device)
    return (device if device.index is not None
            else torch.device("cuda", torch.cuda.current_device()))


def side_streams(device: torch.device, n: int) -> List["torch.cuda.Stream"]:
    """The first n streams of the card's pool of side streams."""
    pool = _SIDE_STREAMS.setdefault(_card(device), [])
    pool.extend(torch.cuda.Stream(device) for _ in range(n - len(pool)))
    return pool[:n]


def side_stream_index(device: torch.device) -> Optional[int]:
    """The index in the card's pool of side streams of the current
    stream; None for another stream, or off the card."""
    if device.type != "cuda":
        return None
    current = torch.cuda.current_stream(device)
    pool = _SIDE_STREAMS.get(_card(device), [])
    return next((i for i, s in enumerate(pool) if s == current), None)


def captured(step: Callable[[], object], device: torch.device,
             within: Optional[span] = None
             ) -> Optional["torch.cuda.CUDAGraph"]:
    """`step`, a function of no arguments on static buffers of the card
    `device`, as a CUDA graph with its own memory pool; inside `eager()`
    None, nothing run.  On the device's one capture stream the step runs
    once eagerly (the libraries' handles and workspaces and the constant
    tables made, so that nothing is copied from the host during the
    capture; its writes stay), then is captured, grad mode and TF32 off
    (the flags are read at the capture, not at a replay).  A capture
    that fails raises.  `within`, the owner's capture span, is open
    around both."""
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph is captured on the card, not on "
                         f"{device}")
    if _eager.depth:
        return None
    with within if within is not None else contextlib.nullcontext():
        side = capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad(), no_tf32():
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                step()
        torch.cuda.synchronize(device)
    return graph
