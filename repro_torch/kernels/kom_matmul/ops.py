"""The limb GEMM and the bf16-limb GEMM: CUDA kernel wrappers and their
plain PyTorch versions.

The limb GEMM replaces the TPU kernel ``repro/kernels/kom_matmul/kom_matmul.py:_int_kernel``
(``kom_matmul_int_raw``): an (m, k) x (k, n) integer GEMM whose int16
operands are split into balanced int8 digits and multiplied in 3
(Karatsuba) or 4 (schoolbook) int8 passes into three int32 accumulators,
recombined once in f32.  The port's wrapper also takes the dequant epilogue
(per-row x per-channel scales, optional bias), because the reference's
jitted forward fuses ``raw * t + b`` into one FMA that must happen before
the result leaves the kernel.  It carries the RGB stem's im2col GEMM and
every FC layer of the integer serving path.

The CUDA source is ``repro_torch/csrc/kom_matmul.cu``.

The bf16-limb GEMM (:func:`bf16x3_matmul`) replaces the TPU kernel
``repro/kernels/kom_matmul/kom_matmul.py:_bf16_kernel``
(``bf16x3_matmul_raw``): an fp32-accurate f32 (m, k) x (k, n) product from
3 or 4 bf16 limb passes, and here also the 3-limb, 6-pass schedule of
``bf16x6``.  It carries the FC layers under the float emulation policies.
Its plain version is :func:`~repro_torch.core.karatsuba.bf16xn_dot_general`
(the same limbs and pairs, summed exactly and rounded once; the kernel
differs from it by its own f32 accumulation error).  The CUDA source is
``repro_torch/csrc/bf16_matmul.cu``: split over K in groups of up to
:data:`BF16_GROUP_K` entries (:func:`bf16_split_k`), the group sums added in
a fixed order by a second kernel, so the result does not change from run
to run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.karatsuba import BF16XN_SCHEDULES, bf16xn_dot_general
from repro_torch.core.substrate import (dequant_epilogue, limb_partials,
                                        limb_recombine)
from repro_torch.kernels import build

_ARGTYPES = {"kom_matmul_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_void_p]}
_BF16_ARGTYPES = {"bf16_matmul_launch": [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p]}

#: K entries one block of the bf16-limb GEMM sums (its nested-sum group),
#: a multiple of the kernel's K tile (:data:`BF16_TILE_K`); halved, down to
#: :data:`BF16_MIN_GROUP_K`, while the grid would give an H100's 132 SMs
#: fewer than two blocks each (:data:`BF16_TARGET_BLOCKS`).
BF16_GROUP_K = 1024
BF16_MIN_GROUP_K = 256
BF16_TILE_K = 32
BF16_BLOCK_N = 128
BF16_TARGET_BLOCKS = 264

NAME = "kom_matmul"
BF16_NAME = "bf16_matmul"


def _check_args(a_q, b_q, variant, base_bits, row_scale, col_scale, bias):
    if variant not in ("karatsuba", "schoolbook"):
        raise ValueError(f"unknown variant: {variant!r}")
    if variant == "karatsuba" and base_bits > 7:
        raise ValueError("karatsuba needs a guard bit: base_bits <= 7")
    if a_q.ndim != 2 or b_q.ndim != 2 or a_q.shape[1] != b_q.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a_q.shape)} x "
                         f"{tuple(b_q.shape)}")
    if (row_scale is None) != (col_scale is None):
        raise ValueError("pass both row_scale and col_scale, or neither")
    if bias is not None and row_scale is None:
        raise ValueError("a bias needs the dequant scales")
    m, n = a_q.shape[0], b_q.shape[1]
    for t, want, what in ((row_scale, (m,), "row_scale"),
                          (col_scale, (n,), "col_scale"), (bias, (n,), "bias")):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{what} must have shape {want}, got "
                             f"{tuple(t.shape)}")


def kom_matmul_int_plain(a_q: torch.Tensor, b_q: torch.Tensor, *,
                         variant: str = "karatsuba", base_bits: int = 7,
                         row_scale=None, col_scale=None, bias=None
                         ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    Exact int32 limb partials (f32 GEMMs over K chunks below 2^24), one f32
    recombine, then ``raw``, ``raw * (s_row * s_col)`` or
    ``fma(raw, s_row * s_col, bias)``.
    """
    _check_args(a_q, b_q, variant, base_bits, row_scale, col_scale, bias)
    p_hh, p_mid, p_ll = limb_partials(a_q, b_q, variant=variant,
                                      base_bits=base_bits)
    raw = limb_recombine(p_hh, p_mid, p_ll, base_bits=base_bits)
    t = None
    if row_scale is not None:
        t = row_scale.to(torch.float32)[:, None] \
            * col_scale.to(torch.float32)[None, :]
    return dequant_epilogue(raw, t, None if bias is None
                            else bias.to(torch.float32))


def kom_matmul_int(a_q: torch.Tensor, b_q: torch.Tensor, *,
                   variant: str = "karatsuba", base_bits: int = 7,
                   row_scale=None, col_scale=None, bias=None) -> torch.Tensor:
    """Integer (m, k) x (k, n) limb GEMM with the fused dequant epilogue.

    ``a_q``/``b_q`` hold integers with |v| <= kom_qmax(base_bits).  Returns
    f32 (m, n).  CUDA tensors run the kernel (any failure raises); CPU
    tensors run :func:`kom_matmul_int_plain`.
    """
    if not build.use_kernel(a_q):
        return kom_matmul_int_plain(a_q, b_q, variant=variant,
                                    base_bits=base_bits, row_scale=row_scale,
                                    col_scale=col_scale, bias=bias)
    _check_args(a_q, b_q, variant, base_bits, row_scale, col_scale, bias)
    dev = a_q.device
    a = a_q.to(torch.int16).contiguous()
    b = b_q.to(device=dev, dtype=torch.int16).contiguous()
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    rs, cs, bs = f32(row_scale), f32(col_scale), f32(bias)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    code = lib.kom_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), build.ptr(rs),
        build.ptr(cs), build.ptr(bs), m, n, k, base_bits,
        int(variant == "karatsuba"), build.stream_ptr(a))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out


def _check_bf16(a, b, passes):
    if passes not in BF16XN_SCHEDULES:
        raise ValueError(f"passes must be one of {sorted(BF16XN_SCHEDULES)}, "
                         f"got {passes}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")


def bf16_split_k(m: int, k: int, n: int) -> dict:
    """How the bf16-limb GEMM kernel splits an (m, k) x (k, n) product.

    ``group_k``: the K entries of one group (see :data:`BF16_GROUP_K`).
    ``bounds``: the [k0, k1) range of each group, one block per (group,
    128 columns, tile of up to 16 rows): ``group_k`` entries from 0 on,
    the last one short when ``k`` is not a multiple.  ``n4``: ``n``
    padded to a multiple of 4 (the kernel reads B in 16-byte copies; the
    wrapper pads and slices).  ``scratch``: the f32 shape (groups, m, n4)
    of the per-group sums that the combine kernel adds in order, or None
    for one group (the blocks then write C).
    """
    if min(m, k, n) <= 0:
        raise ValueError(f"bad GEMM shape ({m}, {k}) x ({k}, {n})")
    n4 = -(-n // 4) * 4
    tiles = -(-n4 // BF16_BLOCK_N) * -(-m // 16)
    group = BF16_GROUP_K
    while group > BF16_MIN_GROUP_K and \
            tiles * -(-k // group) < BF16_TARGET_BLOCKS:
        group //= 2
    bounds = [(k0, min(k, k0 + group)) for k0 in range(0, k, group)]
    return {"group_k": group, "bounds": bounds, "n4": n4,
            "scratch": (len(bounds), m, n4) if len(bounds) > 1 else None}


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bf16x3_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                        passes: int = 3) -> torch.Tensor:
    """The bf16-limb GEMM's function in PyTorch, on any device: the same
    limbs and pairs, their exact sum rounded once to f32."""
    _check_bf16(a, b, passes)
    return bf16xn_dot_general(a, b, passes=passes)


def bf16x3_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  passes: int = 3) -> torch.Tensor:
    """fp32-accurate f32 (m, k) x (k, n) from bf16 limb passes.

    ``passes``: 3 (AhBh + AhBl + AlBh), 4 (+ AlBl) or 6 (three limbs, the
    ``bf16x6`` schedule).  Returns f32 (m, n).  CUDA tensors run the
    kernel (any failure raises); CPU tensors run
    :func:`bf16x3_matmul_plain`.
    """
    if not build.use_kernel(a):
        return bf16x3_matmul_plain(a, b, passes=passes)
    _check_bf16(a, b, passes)
    dev = a.device
    af = a.to(torch.float32).contiguous()
    bf = b.to(device=dev, dtype=torch.float32).contiguous()
    m, k = af.shape
    n = bf.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    plan = bf16_split_k(m, k, n)
    n4 = plan["n4"]
    if n4 != n:
        bf = torch.nn.functional.pad(bf, (0, n4 - n))
    bf = _aligned16(bf)
    out = torch.empty((m, n4), dtype=torch.float32, device=dev)
    scratch = None if plan["scratch"] is None else torch.empty(
        plan["scratch"], dtype=torch.float32, device=dev)
    lib = build.library(BF16_NAME, _BF16_ARGTYPES)
    code = lib.bf16_matmul_launch(af.data_ptr(), bf.data_ptr(),
                                  out.data_ptr(), build.ptr(scratch), m, n4,
                                  k, plan["group_k"], passes,
                                  build.stream_ptr(af))
    build.check_launch(lib, code, BF16_NAME)
    build.LAUNCHES[BF16_NAME] += 1
    return out if n4 == n else out[:, :n].contiguous()
