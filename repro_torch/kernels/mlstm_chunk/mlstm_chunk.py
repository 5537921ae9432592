"""Chunkwise mLSTM: the CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel
``repro/kernels/mlstm_chunk/mlstm_chunk.py:_mlstm_kernel``
(``mlstm_chunk_raw``): gated linear attention over chunks of ``chunk``
tokens, a (dk x dv) state and a (dk) normalizer carried from chunk to
chunk from zero, ``y / max(|n|, 1)``, f32 output.  On the TPU the chunk
axis was a sequential grid axis with the whole (dh x dh) state in VMEM; on
the card only the state's walk is sequential
(``repro_torch/csrc/mlstm_chunk.cu``, which says why): one kernel walks the
chunks per 64 x 64 tile of the state and writes each chunk's start state
to a scratch the library sizes (``mlstm_chunk_scratch``), a second one
forms every chunk's outputs at once.  Every product runs as three TF32
passes on the tensor cores.  The wrapper counts one launch per call (two
kernels; one when the sequence is a single chunk).

:func:`mlstm_chunk_plain` is the model's own chunk loop
(``models.ssm._mlstm_chunk_scan``) from a zero state at the same chunk, in
f32: the CPU path, and what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.models import ssm

NAME = "mlstm_chunk"
#: The largest chunk and head dim the kernels take (their 64 x 64 tiles).
MAX_CHUNK = 64
MAX_DH = 512

_ARGTYPES = {
    "mlstm_chunk_launch": [ctypes.c_void_p] * 7 + [ctypes.c_size_t]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "mlstm_chunk_scratch": ([ctypes.c_int] * 5, ctypes.c_size_t),
}


def _check(q, k, v, log_f, i_gate, chunk):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q/k/v (b, h, s, dh) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if log_f.shape != q.shape[:3] or i_gate.shape != q.shape[:3]:
        raise ValueError(f"need gates (b, h, s) = {tuple(q.shape[:3])}; "
                         f"got {tuple(log_f.shape)}, {tuple(i_gate.shape)}")
    if chunk < 1 or q.shape[2] % chunk:
        raise ValueError(f"s={q.shape[2]} must be a multiple of "
                         f"chunk={chunk}")


def mlstm_chunk_plain(q, k, v, log_f, i_gate, *, chunk: int = 64
                      ) -> torch.Tensor:
    """The model's chunkwise scan from a zero state, in f32, any device."""
    _check(q, k, v, log_f, i_gate, chunk)
    b, h, s, dh = q.shape
    f32 = torch.float32
    s0 = torch.zeros((b, h, dh, dh), dtype=f32, device=q.device)
    n0 = torch.zeros((b, h, dh), dtype=f32, device=q.device)
    y, _, _ = ssm._mlstm_chunk_scan(q.to(f32), k.to(f32), v.to(f32),
                                    log_f.to(f32), i_gate.to(f32), s0, n0,
                                    chunk)
    return y


def mlstm_chunk_raw(q, k, v, log_f, i_gate, *, chunk: int = 64
                    ) -> torch.Tensor:
    """q/k/v (b, h, s, dh) f32 or bf16; log_f/i_gate (b, h, s) f32;
    ``s % chunk == 0`` -> y (b, h, s, dh) f32.

    CUDA tensors run the kernels (chunk <= 64, dh <= 512; anything else
    raises) with a scratch of ``b*h*(s/chunk - 1)*(dh*dh + dh)`` f32 for
    the chunk-start states; CPU tensors run :func:`mlstm_chunk_plain`.
    """
    if not build.use_kernel(q):
        return mlstm_chunk_plain(q, k, v, log_f, i_gate, chunk=chunk)
    _check(q, k, v, log_f, i_gate, chunk)
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes f32 or bf16 q/k/v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_f.dtype != torch.float32 or i_gate.dtype != torch.float32:
        raise ValueError(f"the kernel takes f32 gates, got {log_f.dtype}, "
                         f"{i_gate.dtype}")
    b, h, s, dh = q.shape
    if chunk > MAX_CHUNK or dh > MAX_DH:
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK} and dh <= "
                         f"{MAX_DH}, got chunk {chunk}, dh {dh}")
    dev = q.device
    q, k, v, log_f, i_gate = (t.to(dev).contiguous()
                              for t in (q, k, v, log_f, i_gate))
    out = torch.empty(q.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    nbytes = lib.mlstm_chunk_scratch(b, h, s, dh, chunk)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    code = lib.mlstm_chunk_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
        i_gate.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes, b, h,
        s, dh, chunk, int(q.dtype == torch.bfloat16), build.stream_ptr(q))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
