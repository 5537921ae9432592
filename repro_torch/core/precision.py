"""Matmul precision policies: the single switch every linear layer uses.

The port of ``repro.core.precision`` for ``fp32``, ``native_bf16``, the
bf16x3/bf16x6 emulation schedules and the two integer KOM policies with a
cached :class:`QWeight`.  The integer policies with FLOAT weights (the
reference's straight-through training path) are not ported yet.
"""
from __future__ import annotations

import enum

import torch

from .substrate import (QWeight, dequantize_weight, not_ported,
                        policy_int_spec, prequant_dot_general)


class MatmulPolicy(str, enum.Enum):
    NATIVE_BF16 = "native_bf16"        # 1 pass,  bf16 accuracy (baseline)
    BF16X3 = "bf16x3"                  # 3 passes, ~fp32 accuracy (KOM count)
    BF16X6 = "bf16x6"                  # 6 passes, fp32+ accuracy
    KOM_INT14 = "kom_int14"            # 3 int8 passes, W14A14 quantized
    SCHOOLBOOK_INT16 = "schoolbook_int16"  # 4 int8 passes, W16A16 quantized
    FP32 = "fp32"                      # native f32


def policy_dot_general(a: torch.Tensor, b, *, policy=MatmulPolicy.NATIVE_BF16,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """(..., k) x (k, n) under a policy, with an optional bias (n,).

    Integer policies need a cached :class:`QWeight` ``b``; their bias rides
    the limb GEMM's epilogue as ``fma(raw, t, b)``, as the reference's
    jitted ``policy_linear(x, w) + b`` computes it.  Float policies
    dequantize a cached QWeight first and add the bias after the product;
    under ``bf16x3``/``bf16x6`` the product runs on the bf16-limb GEMM
    kernel (its plain version, ``bf16xn_dot_general``, on the CPU).
    """
    policy = MatmulPolicy(policy)
    spec = policy_int_spec(policy)
    if spec is not None:
        if not isinstance(b, QWeight):
            raise not_ported(
                "integer policies on float weights",
                "Queue 1 item 2: the straight-through training path")
        return prequant_dot_general(a, b, variant=spec[0], bias=bias)
    if isinstance(b, QWeight):
        b = dequantize_weight(b)
    if policy == MatmulPolicy.NATIVE_BF16:
        out = torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16))
    elif policy == MatmulPolicy.FP32:
        out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    else:
        from repro_torch.kernels.kom_matmul import bf16x3_matmul
        out = bf16x3_matmul(
            a.reshape(-1, a.shape[-1]), b,
            passes=3 if policy == MatmulPolicy.BF16X3 else 6,
        ).reshape(a.shape[:-1] + (b.shape[-1],))
    return out if bias is None else out + bias


def policy_matmul(a, b, *, policy=MatmulPolicy.NATIVE_BF16):
    return policy_dot_general(a, b, policy=policy)


def policy_linear(x: torch.Tensor, w, *, policy=MatmulPolicy.NATIVE_BF16,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """(..., k) @ (k, n) (+ bias) under a policy; the models' matmul entry."""
    lead = x.shape[:-1]
    out = policy_dot_general(x.reshape(-1, x.shape[-1]), w, policy=policy,
                             bias=bias)
    return out.reshape(lead + (w.shape[-1],))
