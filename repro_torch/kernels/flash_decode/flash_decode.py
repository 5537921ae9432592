"""Flash decode: the CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/flash_decode/flash_decode.py:_decode_kernel``
(``flash_decode_raw``): one query token per (batch, q-head) against a KV
cache (b, hkv, S, dh), keys at positions ``<= pos`` valid, f32 math, the
output in q's dtype.  On the TPU the KV-block grid axis ran in order and
combined the blocks' online-softmax partials in VMEM scratch; on the card
the blocks are split-K partials combined by a second pass
(``repro_torch/csrc/flash_decode.cu``, which says why).  The split size
follows the grid (:func:`flash_decode_splits`).  The wrapper counts one
launch per call (the split and combine kernels together).

Masked scores are ``-1e30`` (not ``-inf``), as in the reference; since key
0 is valid whenever ``pos >= 0``, keys past ``pos`` add exactly nothing and
the kernel skips them (see the CUDA source).  :func:`flash_decode_plain`
walks every block, the reference's arithmetic literally.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
NAME = "flash_decode"

_ARGTYPES = {"flash_decode_launch": [ctypes.c_void_p] * 7
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]}
#: Keys per chunk of the kernel's cp.async ring; a split is a multiple.
CHUNK = 64
#: Head dims the kernel is built for (one 16-byte slice per lane).
KERNEL_DH = (16, 32, 64, 128)
#: Streaming multiprocessors of an H100 SXM (the wrapper asks the device).
H100_SMS = 132


def flash_decode_splits(S: int, b: int, hkv: int, *, sms: int = H100_SMS
                        ) -> tuple:
    """(keys per split, number of splits) for a cache of S keys.

    The kernel runs one block per (split, kv-head, batch) and q-head group,
    so the split is the largest multiple of :data:`CHUNK` that still gives
    ``b * hkv * nsplit >= 2 * sms`` (every SM gets two blocks or more), and
    one chunk where S is too short for that.
    """
    want = max(1, -(-2 * sms // max(1, b * hkv)))
    split = max(CHUNK, -(-(-(-S // want)) // CHUNK) * CHUNK)
    while split > CHUNK and -(-S // split) < want:
        split -= CHUNK
    return split, -(-S // split)


def valid_keys(k_pos: torch.Tensor, pos: int) -> torch.Tensor:
    """Which cache positions the query attends to: ``k_pos <= pos``."""
    return k_pos <= pos


def _check(q, k, v):
    if q.ndim != 4 or q.shape[2] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q (b,hq,1,dh), k/v (b,hkv,S,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or \
            q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and the cache "
                         f"{tuple(k.shape)} do not form a GQA pair")


def flash_decode_plain(q, k, v, pos: int, *, block_k: int = 512
                       ) -> torch.Tensor:
    """The TPU kernel's block schedule in PyTorch, on any device.

    ``k``/``v`` hold S keys, a multiple of ``block_k`` (the public wrapper
    pads).  Per block: f32 scores ``(q . k) / sqrt(dh)`` with ``-1e30``
    past ``pos``, running max, ``exp``, ``alpha`` rescale; at the end
    ``acc / l`` with ``l == 0 -> 1``.  GQA by index.
    """
    _check(q, k, v)
    b, hq, _, dh = q.shape
    hkv, S = k.shape[1], k.shape[2]
    g = hq // hkv
    if S % block_k:
        raise ValueError(f"S={S} must be a multiple of block_k={block_k}")
    denom = torch.full((), dh ** 0.5, dtype=torch.float32, device=q.device)
    q32 = q.to(torch.float32).reshape(b, hkv, g, 1, dh)
    m = torch.full((b, hkv, g, 1, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, 1, dh), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, S, block_k):
        kb = k[:, :, None, k0:k0 + block_k].to(torch.float32)
        vb = v[:, :, None, k0:k0 + block_k].to(torch.float32)
        s = torch.matmul(q32, kb.transpose(-1, -2)) / denom
        k_pos = torch.arange(k0, k0 + block_k, device=q.device)
        s = torch.where(valid_keys(k_pos, pos), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, 1, dh).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel's copies
    are 16 bytes)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_decode_raw(q, k, v, pos: int, *, block_k: int = 512
                     ) -> torch.Tensor:
    """q (b, hq, 1, dh); k/v (b, hkv, S, dh), S a multiple of ``block_k``;
    ``pos`` the last valid cache position -> (b, hq, 1, dh) in q's dtype.

    CUDA tensors run the kernel (any failure raises); CPU tensors run
    :func:`flash_decode_plain`.  The kernel takes f32 or bf16.
    """
    pos = int(pos)
    if not build.use_kernel(q):
        return flash_decode_plain(q, k, v, pos, block_k=block_k)
    _check(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, _, dh = q.shape
    hkv, S = k.shape[1], k.shape[2]
    if S % block_k:
        raise ValueError(f"S={S} must be a multiple of block_k={block_k}")
    if dh not in KERNEL_DH:
        raise ValueError(f"the kernel takes dh in {KERNEL_DH}, got {dh}")
    dev = q.device
    q, k, v = (_aligned(t) for t in (q, k.to(dev), v.to(dev)))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    split, nsplit = flash_decode_splits(S, b, hkv, sms=build.num_sms(dev))
    rows = b * hq * nsplit
    scratch = torch.empty((rows * (dh + 2),), dtype=torch.float32,
                          device=dev)  # pacc (rows, dh), then pm, pl
    base = scratch.data_ptr()
    code = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        base + 4 * rows * dh, base + 4 * rows * (dh + 1), base, b, hq, hkv,
        S, dh, pos, split, nsplit, int(q.dtype == torch.bfloat16),
        float(np.float32(dh ** 0.5)), build.stream_ptr(q))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
