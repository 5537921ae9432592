"""Matmul precision policies: the single switch every linear layer uses.

The port of ``repro.core.precision`` for ``fp32``, ``native_bf16``, the
bf16x3/bf16x6 emulation schedules and the two integer KOM policies, with a
cached :class:`QWeight` or with a float weight (:func:`kom_q_dot`, the
reference's ``_kom_q_dot``: both operands quantized per tensor, inference
only -- the straight-through gradient is not ported yet).
"""
from __future__ import annotations

import enum

import torch

from .substrate import (QWeight, dequantize_weight, kom_qmax, not_ported,
                        policy_int_spec, prequant_dot_general,
                        quantize_values)


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

    Integer policies with a cached :class:`QWeight` ``b`` quantize the
    activation per row; with a float ``b`` both operands per tensor
    (:func:`kom_q_dot`).  Their bias rides the limb GEMM's epilogue as
    ``fma(raw, t, b)``, as the reference's jitted ``policy_linear(x, w) +
    b`` computes it.  Float policies
    dequantize a cached QWeight first and add the bias after the product;
    under ``bf16x3``/``bf16x6`` the product runs on the bf16-limb GEMM
    kernel (its plain version, ``bf16xn_dot_general``, on the CPU).
    """
    policy = MatmulPolicy(policy)
    spec = policy_int_spec(policy)
    if spec is not None:
        if not isinstance(b, QWeight):
            return kom_q_dot(a, b, variant=spec[0], base_bits=spec[1],
                             bias=bias)
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


def operand_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``max(amax, 1e-12) / qmax`` as a true division: the scale
    :func:`kom_q_dot` gives each operand (the reference's eager rule)."""
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, qmax)


def kom_q_dot(a: torch.Tensor, b: torch.Tensor, *, variant: str,
              base_bits: int, bias: torch.Tensor | None = None
              ) -> torch.Tensor:
    """(m, k) x (k, n) with BOTH float operands quantized per tensor.

    The forward of the reference's ``_kom_q_dot``: each operand's scale is
    ``max(amax, 1e-12) / qmax`` (a true division), its values
    ``clip(round(x / scale))``, the product the exact limb GEMM recombined
    once in f32, times ``s_a * s_b``.  That is the reference's eager
    arithmetic bit for bit; its jitted callers round differently from
    shape to shape (ROADMAP.md, Queue 3) and land within ~3e-5 of it.  It
    runs on the limb GEMM kernel (plain version on the CPU) with every row
    scale ``s_a`` and every column scale ``s_b``, which forms the same
    ``raw * fl(s_a * s_b)``.  Inference only: the straight-through gradient
    (``_kom_dot_ste``) is not ported.
    """
    from repro_torch.kernels.kom_matmul import kom_matmul_int

    if (a.requires_grad or b.requires_grad) and torch.is_grad_enabled():
        raise not_ported("gradients through an integer policy on float "
                         "weights", "Queue 1, the straight-through "
                         "training path")
    qmax = kom_qmax(base_bits)

    def quantize(x):
        x = x.to(torch.float32)
        scale = operand_scale(x.abs().amax(), qmax)
        return quantize_values(x, scale, qmax).to(torch.int16), scale

    qa, sa = quantize(a)
    qb, sb = quantize(b.to(a.device))
    m, n = a.shape[0], b.shape[-1]
    return kom_matmul_int(qa, qb, variant=variant, base_bits=base_bits,
                          row_scale=sa.expand(m).contiguous(),
                          col_scale=sb.expand(n).contiguous(), bias=bias)


def policy_matmul(a, b, *, policy=MatmulPolicy.NATIVE_BF16):
    return policy_dot_general(a, b, policy=policy)


def policy_linear(x: torch.Tensor, w, *, policy=MatmulPolicy.NATIVE_BF16,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """(..., k) @ (k, n) (+ bias) under a policy; the models' matmul entry."""
    lead = x.shape[:-1]
    out = policy_dot_general(x.reshape(-1, x.shape[-1]), w, policy=policy,
                             bias=bias)
    return out.reshape(lead + (w.shape[-1],))
