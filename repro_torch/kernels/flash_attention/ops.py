"""Public wrapper for the flash attention kernel (pads the keys)."""
from __future__ import annotations

import torch.nn.functional as F

from .flash_attention import flash_attention_raw


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    block_q=128, block_k=128):
    """Fused attention; q (b,hq,sq,d), k/v (b,hkv,skv,d) -> (b,hq,sq,d).

    Pads skv to a block multiple with zero keys and values, as the
    reference does: with ``causal`` a padded key sits past every query
    whose position is below skv; non-causal inputs whose skv is not a
    block multiple raise, as in the reference.  q needs no padding (rows
    are independent), so ``block_q`` only mirrors the reference's
    signature.
    """
    del block_q
    skv = k.shape[2]
    bk = min(block_k, max(skv, 16))
    pk = (-skv) % bk
    if pk and not causal:
        raise ValueError(
            "non-causal flash_attention requires skv divisible by block_k "
            f"(got skv={skv}, block_k={bk}); pick a divisor block")
    if pk:
        k = F.pad(k, (0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, pk))
    return flash_attention_raw(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, block_k=bk)
