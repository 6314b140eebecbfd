"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`, as the tests do).  Without a card and without that
request they raise: nothing carries on silently on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


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
