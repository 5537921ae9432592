"""Public wrapper for the decode attention kernel (pads the cache)."""
from __future__ import annotations

import torch.nn.functional as F

from .flash_decode import flash_decode_raw


def flash_decode(q, k, v, pos, *, block_k: int = 512):
    """One-token decode attention; q (b,hq,1,dh), cache (b,hkv,S,dh).

    Pads S to a multiple of ``bk = min(block_k, S)`` with zero keys and
    values, as the reference does (padded keys sit past every valid
    ``pos < S``).
    """
    skv = k.shape[2]
    bk = min(block_k, skv)
    pk = (-skv) % bk
    if pk:
        k = F.pad(k, (0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, pk))
    return flash_decode_raw(q, k, v, pos, block_k=bk)
