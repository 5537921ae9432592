"""The port's hand-written CUDA kernels, each beside its plain version.

Kernel sources live in ``repro_torch/csrc``; :mod:`.build` compiles them
lazily.  Importing this package needs no CUDA toolkit.
"""
from .build import launch_counts, reset_launches

__all__ = ["launch_counts", "reset_launches"]
