"""GQA attention with RoPE, KV cache, causal/local masking (the port of
``repro.models.attention``).

Two execution paths for the score/softmax/PV pipeline, as in the
reference:

* plain PyTorch (:func:`dot_attention_torch`, :func:`chunked_attention_torch`),
  the arithmetic of the reference's ``dot_attention_jnp`` and
  ``chunked_attention_jnp``: additive ``-1e30`` mask bias, softmax, f32;
  the cached decode path always runs :func:`dot_attention_torch`;
* the flash-attention kernel (``use_kernel=True``, cache-free path):
  :func:`repro_torch.kernels.flash_attention.flash_attention`, which
  SELECTS ``-1e30`` where masked -- each path keeps its own arithmetic.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .layers import dense, linear_init, norm_init, rms_norm, rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (b, kv_heads, max_len, head_dim)
    v: torch.Tensor


def attn_init(gen: torch.Generator, cfg, dtype=torch.float32, bias=False):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": linear_init(gen, d, hq * dh, dtype),
        "wk": linear_init(gen, d, hkv * dh, dtype),
        "wv": linear_init(gen, d, hkv * dh, dtype),
        "wo": linear_init(gen, hq * dh, d, dtype),
    }
    if bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=dev)
    if getattr(cfg, "qk_norm", False):
        p["q_norm"] = norm_init(dh, "rms", dtype, dev)
        p["k_norm"] = norm_init(dh, "rms", dtype, dev)
    return p


def _mask_bias(q_pos, k_pos, *, causal, window, k_len_valid=None):
    """ADDITIVE mask bias (1, 1, sq, skv) in f32: 0 or -1e30."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_len_valid is not None:
        m &= k_pos[None, :] < k_len_valid
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(m, zero, NEG_INF)[None, None]


def _sqrt_dh(dh: int, device) -> torch.Tensor:
    """sqrt(dh) as a 0-dim f32 tensor made on ``device`` (a true division
    by it on any device; no host-to-device copy)."""
    return torch.full((), dh ** 0.5, dtype=torch.float32, device=device)


def _repeat_kv(k, v, g):
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    return k, v


def dot_attention_torch(q, k, v, *, causal, window, q_offset,
                        k_len_valid=None):
    """q (b,hq,sq,dh); k/v (b,hkv,skv,dh) -> (b,hq,sq,dh): the whole score
    matrix, the mask added as a bias, softmax in f32."""
    b, hq, sq, dh = q.shape
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, hq // k.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) \
        / _sqrt_dh(dh, q.device)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                       k_len_valid=k_len_valid)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)


def chunked_attention_torch(q, k, v, *, causal, window, q_offset,
                            k_len_valid=None, chunk=1024):
    """Online softmax over KV chunks (the reference's ``lax.scan`` version):
    never materializes the (sq, skv) score matrix."""
    b, hq, sq, dh = q.shape
    skv = k.shape[2]
    k, v = _repeat_kv(k, v, hq // k.shape[1])
    if skv % chunk:
        chunk = skv  # fallback: single chunk
    q32 = q.to(torch.float32) / _sqrt_dh(dh, q.device)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hq, sq, dh), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kb = k[:, :, c0:c0 + chunk].to(torch.float32)
        vb = v[:, :, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb)
        k_pos = c0 + torch.arange(chunk, device=q.device)
        mask = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        if k_len_valid is not None:
            mask &= k_pos[None, :] < k_len_valid
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.to(q.dtype)


def _update_rows(cache: torch.Tensor, new: torch.Tensor, start: int
                 ) -> torch.Tensor:
    """``lax.dynamic_update_slice(cache, new, (0, 0, start, 0))`` as a new
    tensor; the start is clamped so the update fits, as XLA clamps it."""
    s = new.shape[2]
    start = min(max(start, 0), cache.shape[2] - s)
    out = cache.clone()
    out[:, :, start:start + s] = new.to(cache.dtype)
    return out


def attention(params, x, cfg, *, positions, cache: Optional[KVCache] = None,
              causal: bool = True, window: Optional[int] = None,
              use_rope: bool = True, use_kernel: bool = False,
              kv_override=None, start: Optional[int] = None):
    """Full attention sublayer: proj -> rope -> (cache) -> attn -> out proj.

    Training/prefill: cache=None, positions (s,).  Decode: cache given, x
    the new token block (b, s, d), positions (s,) from the first new
    token's index.  ``start`` is that index as a Python int (the caller
    knows it on the host; without it the port reads ``positions[0]`` back
    from the device, one sync per layer).  ``kv_override``: (k, v)
    tensors for cross-attention (already projected).  Returns
    (y, new_cache); the input cache is not modified.
    """
    b, s, d = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    policy = cfg.policy
    q = dense(x, params["wq"], policy=policy, bias=params.get("bq"))
    q = q.reshape(b, s, hq, dh)
    if kv_override is None:
        k = dense(x, params["wk"], policy=policy,
                  bias=params.get("bk")).reshape(b, s, hkv, dh)
        v = dense(x, params["wv"], policy=policy,
                  bias=params.get("bv")).reshape(b, s, hkv, dh)
    else:
        k, v = kv_override
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"]["w"])
        if kv_override is None:
            k = rms_norm(k, params["k_norm"]["w"])
    if use_rope:
        q = rope(q, positions, theta=cfg.rope_theta)
        if kv_override is None:
            k = rope(k, positions, theta=cfg.rope_theta)
    q = q.transpose(1, 2)  # (b, hq, s, dh)
    if kv_override is None:
        # projected K/V are (b, s, hkv, dh); overrides arrive pre-transposed
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)

    new_cache = None
    if cache is not None:
        if start is None:
            pt = torch.as_tensor(positions)
            start = int(pt if pt.ndim == 0 else pt.reshape(-1)[0])
        ck = _update_rows(cache.k, k, start)
        cv = _update_rows(cache.v, v, start)
        new_cache = KVCache(ck, cv)
        out = dot_attention_torch(q, ck, cv, causal=causal, window=window,
                                  q_offset=start, k_len_valid=start + s)
    elif use_kernel:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=0)
    elif k.shape[2] > getattr(cfg, "attn_dense_max", 2048):
        out = chunked_attention_torch(q, k, v, causal=causal, window=window,
                                      q_offset=0,
                                      chunk=getattr(cfg, "attn_chunk", 1024))
    else:
        out = dot_attention_torch(q, k, v, causal=causal, window=window,
                                  q_offset=0)
    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    y = dense(out, params["wo"], policy=policy, bias=params.get("bo"))
    return y, new_cache
