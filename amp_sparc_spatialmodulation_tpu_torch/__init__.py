"""PyTorch and CUDA port of the AMP/SPARC spatial-modulation receiver framework.

The JAX package ``amp_sparc_spatialmodulation_tpu`` beside this one is the
reference; this package keeps its module names and public layouts
(complex64 ``(B, N)`` / ``(B, n)`` vectors, flat index ``l*Nt + antenna``)
and runs on an NVIDIA GPU.  The BAMP decode runs through a hand-written
CUDA kernel (``ops/kernels/csrc/fused_bamp_decode.cu``) built with ``nvcc``
at first use.  Nothing here imports JAX or the JAX package.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .config import Config  # noqa: F401

__version__ = "0.1.0"
