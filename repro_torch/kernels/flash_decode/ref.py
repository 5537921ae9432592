"""Materialized-softmax oracle for the decode attention kernel."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, pos):
    """q (b,hq,1,dh); k/v (b,hkv,S,dh); attend to cache positions <= pos."""
    b, hq, _, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    kk = torch.repeat_interleave(k, g, dim=1).to(torch.float32)
    vv = torch.repeat_interleave(v, g, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) \
        / torch.full((), dh ** 0.5, dtype=torch.float32, device=q.device)
    mask = torch.arange(skv, device=q.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
