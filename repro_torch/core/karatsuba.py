"""The bf16-limb float schedules: fp32-accurate products from bf16 passes.

The port of the float half of ``repro.core.karatsuba`` (a residual split
into bf16 limbs, not the algebraic identity); the integer Karatsuba-Ofman
passes live in :mod:`repro_torch.core.substrate`.

The float kernels' plain versions are built on :func:`schedule_dot`, the
schedule's EXACT value: every limb product is exact (a bf16 x bf16 product
has 16 significant bits, an f32 x f32 one 48), and the port sums them in
f64, so the only rounding left is the final one to f32.  Any f32
implementation -- XLA's dots, the CUDA kernels -- differs from it by its
own accumulation error alone, which is what lets a tight tolerance tell
the schedules apart (their gaps are ~3e-6 of the largest output; see
``tests/test_torch_float.py``).

Shapes follow the port's convention, ``(..., k) x (k, n)``.
"""
from __future__ import annotations

import torch

#: bf16 limb passes per schedule: (limbs per operand, limb-index pairs).
#: The pairs keep limb orders i + j <= 4 (1-based) -- for 6 passes the
#: classic bf16_6x emulation schedule.  Summed exactly, their order does
#: not matter.
BF16XN_SCHEDULES = {
    3: (2, ((0, 0), (0, 1), (1, 0))),
    4: (2, ((0, 0), (0, 1), (1, 0), (1, 1))),
    6: (3, ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))),
}
#: Every schedule :func:`schedule_dot` takes; 1 pass is native f32.
SCHEDULES = {1: (1, ((0, 0),)), **BF16XN_SCHEDULES}


def float_split(x: torch.Tensor, terms: int = 2) -> list:
    """Split f32 into ``terms`` bf16 limbs, x ~= sum(limbs) (residual split).

    Each limb is the residual rounded to nearest even (``.to(bfloat16)``),
    and each residual ``x - f32(hi)`` is exact in f32.
    """
    x = x.to(torch.float32)
    limbs = []
    for _ in range(terms - 1):
        hi = x.to(torch.bfloat16)
        limbs.append(hi)
        x = x - hi.to(torch.float32)
    limbs.append(x.to(torch.bfloat16))
    return limbs


def schedule_dot(a: torch.Tensor, b: torch.Tensor, *,
                 passes: int) -> torch.Tensor:
    """The exact f64 value of (..., k) x (k, n) under a pass schedule.

    ``passes=1``: the f32 operands' exact product sum (native f32).
    ``passes=3/4/6``: the bf16 limb pairs of :data:`BF16XN_SCHEDULES`.
    Products are exact and f64 sums lose ~2^-53 per add, so the result is
    the schedule's value up to far less than one f32 ulp (TF32 never
    applies to f64 GEMMs).
    """
    if passes not in SCHEDULES:
        raise ValueError(f"unsupported pass count: {passes}")
    terms, pairs = SCHEDULES[passes]
    if terms == 1:
        al, bl = [a.to(torch.float32)], [b.to(torch.float32)]
    else:
        al, bl = float_split(a, terms), float_split(b, terms)
    out = None
    for i, j in pairs:
        d = torch.matmul(al[i].to(torch.float64), bl[j].to(torch.float64))
        out = d if out is None else out + d
    return out


def bf16xn_dot_general(a: torch.Tensor, b: torch.Tensor, *,
                       passes: int = 3) -> torch.Tensor:
    """fp32-accurate (..., k) x (k, n) from bf16 passes, as f32.

    passes=3: AhBh + AhBl + AlBh (2-limb split, AlBl dropped); passes=4:
    + AlBl; passes=6: 3-limb split keeping the pairs with limb order
    i + j <= 4.  The reference sums each pass as one f32 dot; the port
    returns the schedule's exact value rounded once (:func:`schedule_dot`).
    """
    if passes not in BF16XN_SCHEDULES:
        raise ValueError(f"unsupported pass count: {passes}")
    return schedule_dot(a, b, passes=passes).to(torch.float32)
