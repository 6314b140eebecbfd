"""fpsc_tpu_torch: the PyTorch / CUDA port of fpsc_tpu for one NVIDIA H100.

The JAX package `fpsc_tpu` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of the host-side
modules it needs.  Plain tensor code is PyTorch; the LPCNet sampler,
the one Pallas kernel on the decode path, is a hand-written CUDA
kernel (csrc/lpcnet_sampler.cu).  Subpackages mirror fpsc_tpu/.
"""

__version__ = "0.1.0"
