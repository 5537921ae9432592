"""int32 overflow bounds of the limb conv engines (shared by every model).

The systolic conv kernel itself (``repro/kernels/conv2d/conv2d.py:
_conv_kernel``) is not ported yet; these two bounds are what the implicit
and Winograd engines' exactness models derive from.
"""
from __future__ import annotations


def limb_term_bound(variant: str, base_bits: int) -> int:
    """Worst-case |contribution| of ONE term to the widest int32 partial:
    Karatsuba's mid term 6*half^2, schoolbook's 2*half^2."""
    half = 1 << (base_bits - 1)
    return (6 if variant == "karatsuba" else 2) * half * half


def int_accum_bound(kh: int, kw: int, cin: int, *, variant: str,
                    base_bits: int) -> int:
    """Worst-case |value| of the widest int32 accumulator over kh*kw*cin."""
    return limb_term_bound(variant, base_bits) * kh * kw * cin
