"""PyTorch and CUDA port of the KOM (Karatsuba-Ofman) CNN serving system.

``repro_torch`` mirrors the JAX package's layout (``core``, ``kernels``,
``models``, ``serving``, ``configs``, ``launch``) and reproduces its integer
results bit for bit.  The conv and GEMM kernels on the integer AlexNet /
VGG serving path are hand-written CUDA C++ for Hopper (``csrc/``), built with
``nvcc`` at first use; every kernel has a plain PyTorch version beside it,
which is what runs for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
