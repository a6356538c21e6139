"""sdrjfm_tpu_torch — the broadcast-FM receive chain in PyTorch, for an NVIDIA H100.

A port of the `sdrjfm_tpu` package (JAX on a TPU), module for module and
name for name.  This package imports neither JAX nor `sdrjfm_tpu`: the
numpy-only host modules it needs (constants, filter design, wav I/O, the
synthetic capture, the RDS host stack) are kept here as copies.

The main path runs on the card: wire-format IQ -> the fused front end (a
CUDA kernel, `kernels/frontend.py`) -> discriminator, pilot, PSS, stereo
matrix and audio tail (torch ops, cuFFT) -> RDS bit recovery; the one-pole
trackers run through a Triton scan kernel (`kernels/linrec.py`).  Every
kernel has a plain-torch twin that the wrappers use for CPU tensors, so the
whole chain also runs (slowly) on the CPU, which is how the tests compare
it with the JAX package.
"""

from . import constants

__version__ = "0.1.0"
