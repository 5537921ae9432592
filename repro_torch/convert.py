"""Convert the JAX package's CNN params into the port's.

Both packages keep params as a list of per-layer dicts in NHWC / HWIO
layout, so the conversion is one tensor per array; torch and JAX random
generators differ, so differential tests make params on one side and carry
them across here.  The input is host data -- numpy arrays, e.g.
``jax.tree.map(np.asarray, cnn_init(cfg, key))`` -- so this module needs
neither JAX nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(params, *, device=None) -> list:
    """[{"w": array, "b": array}, {}, ...] -> the same list of f32 tensors
    on ``device`` (default: the GPU, see resolve_device)."""
    dev = resolve_device(device)
    out = []
    for p in params:
        out.append({k: torch.from_numpy(np.array(v, dtype=np.float32,
                                                  copy=True)).to(dev)
                    for k, v in p.items()})
    return out
