"""Materialized-softmax oracle for the flash attention kernel."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0):
    """Attention with GQA + causal/local masking, the whole score matrix at
    once (the port of ``repro.kernels.flash_attention.ref.attention_ref``)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    kk = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) \
        / torch.full((), d ** 0.5, dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
