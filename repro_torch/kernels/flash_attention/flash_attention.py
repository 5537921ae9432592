"""Flash attention: the CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py:_attn_kernel``
(``flash_attention_raw``): online-softmax attention with GQA, causal and
sliding-window masks and a ``q_offset``, f32 math, the output in q's
dtype.  On the TPU its KV grid axis ran in order and carried the running
max ``m``, denominator ``l`` and accumulator in VMEM scratch; on the card
one thread block owns (batch, q-head, 128-row q block) and walks the KV
blocks itself (``repro_torch/csrc/flash_attention.cu``).

Masked scores are ``-1e30``, not ``-inf``, as in the reference.  A KV block
that is wholly masked for a row BEFORE its first live key gives that row
``p = exp(0) = 1`` for every entry, and the next live block's ``alpha =
exp(-1e30 - m) = 0`` wipes it; a wholly masked block AFTER a live key adds
exactly nothing (``p = 0``, ``alpha = 1``).  So for a row with at least one
live key, skipping wholly masked blocks is exact, while a row with none
averages every (padded) value.  :func:`flash_attention_plain` walks every
block, the reference's arithmetic literally; the kernel skips the blocks
outside the live range of its 128 rows unless one of them has no live key,
and then walks every block too.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
NAME = "flash_attention"
#: Head dims the kernel is instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

_ARGTYPES = {"flash_attention_launch": [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]}


def live_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window) -> torch.Tensor:
    """(sq, bk) bool: which keys a query may attend to."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (b,hq,sq,d), k/v (b,hkv,skv,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA pair (hq % hkv == 0, same b and d)")


def flash_attention_plain(q, k, v, *, causal=True, window=None, q_offset=0,
                          block_k=128) -> torch.Tensor:
    """The TPU kernel's block schedule in PyTorch, on any device.

    ``k``/``v`` hold ``skv`` keys, a multiple of ``block_k`` (the public
    wrapper pads).  Per KV block: f32 scores ``(q . k) * scale`` with
    ``-1e30`` where masked, running max, ``exp``, ``alpha`` rescale; at the
    end ``acc / l`` with ``l == 0 -> 1``.  GQA by index: q-head ``h`` reads
    kv-head ``h // group``.  Rows are independent, so q needs no padding.
    """
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    if skv % block_k:
        raise ValueError(f"skv={skv} must be a multiple of block_k={block_k}")
    scale = float(np.float32(1.0 / d ** 0.5))
    q32 = q.to(torch.float32).reshape(b, hkv, g, sq, d)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, skv, block_k):
        kb = k[:, :, None, k0:k0 + block_k].to(torch.float32)
        vb = v[:, :, None, k0:k0 + block_k].to(torch.float32)
        s = torch.matmul(q32, kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + block_k, device=q.device)
        s = torch.where(live_mask(q_pos, k_pos, causal=causal,
                                  window=window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_raw(q, k, v, *, causal=True, window=None, q_offset=0,
                        block_k=128) -> torch.Tensor:
    """q (b, hq, sq, d); k/v (b, hkv, skv, d), skv a multiple of ``block_k``
    (the wrapper pads) -> (b, hq, sq, d) in q's dtype.

    CUDA tensors run the kernel (any failure raises); CPU tensors run
    :func:`flash_attention_plain`.  The kernel takes f32 or bf16 and head
    dims :data:`KERNEL_HEAD_DIMS`.
    """
    if not build.use_kernel(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, block_k=block_k)
    _check(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if skv % block_k:
        raise ValueError(f"skv={skv} must be a multiple of block_k={block_k}")
    dev = q.device
    q, k, v = (t.contiguous() for t in (q, k.to(dev), v.to(dev)))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        sq, skv, d, int(causal), int(window is not None),
        0 if window is None else int(window), int(q_offset),
        int(q.dtype == torch.bfloat16), float(np.float32(1.0 / d ** 0.5)),
        build.stream_ptr(q))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
