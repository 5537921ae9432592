"""Roofline floor of one conv layer on one NVIDIA H100 (the port of
``repro.analysis.roofline``'s ``conv_mult_counts`` / ``conv_layer_roofline``).

Priced with the H100 SXM's published dense peaks (NVIDIA data sheet):
int8 tensor-core operations 1,979 TOP/s, bf16 989 TFLOP/s, HBM3 3.35 TB/s,
all at the 700 W power limit.  No TPU constant is used here.  The port's
kernels run their int8 digit passes on the CUDA cores (``__dp4a``), far
below the tensor-core peak, so the compute term is a floor, not a
prediction; it is what the explorer's ``--model-only`` mode ranks by.
"""
from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM, dense, published peaks at 700 W.
H100 = {
    "peak_int8": 1979e12,   # int8 tensor-core operations per second
    "peak_bf16": 989e12,    # bf16 tensor-core FLOP per second
    "hbm_bw": 3.35e12,      # HBM3 bytes per second
}

#: int8 passes one wide multiply costs per limb variant.
_VARIANT_PASSES = {"karatsuba": 3, "schoolbook": 4}


def conv_mult_counts(path: str, *, kh, kw, stride, h, cin, cout,
                     n: int = 1) -> Dict[str, float]:
    """Wide-multiply demand of one SAME conv layer per engine.

    ``direct``: ho*wo*kh*kw*cin*cout, what every direct engine (im2col,
    implicit) issues.  ``mults``: what ``path`` issues -- Winograd
    F(2x2, 3x3) replaces each 2x2 output tile's 36 MACs by 16 transformed
    products, tiles*16*cin*cout (2.25x fewer on even maps).
    """
    ho = wo = -(-h // stride)
    direct = float(n * ho * wo * kh * kw * cin * cout)
    if path == "winograd":
        tiles = n * (-(-ho // 2)) * (-(-wo // 2))
        mults = float(tiles * 16 * cin * cout)
    else:
        mults = direct
    return {"mults": mults, "direct_mults": direct,
            "transform_saving": direct / max(mults, 1.0)}


def conv_layer_roofline(path: str, *, kh, kw, stride, h, cin, cout,
                        variant: str = "karatsuba", n: int = 1,
                        fusion: str = "bias_relu",
                        handoff_in: bool = False) -> Dict[str, float]:
    """H100 roofline floor of one conv layer on engine ``path`` (seconds).

    compute_s: 2 operations per wide multiply times the variant's int8
    pass count at the int8 peak (float policies: the bf16 peak, one pass).
    memory_s: the port's modeled device-memory traffic
    (:func:`repro_torch.core.tuning.conv_hbm_bytes`) at the HBM rate.  The
    floor is their max; ``fusion``/``handoff_in`` move only memory_s.
    """
    from repro_torch.core.tuning import conv_hbm_bytes

    counts = conv_mult_counts(path, kh=kh, kw=kw, stride=stride, h=h,
                              cin=cin, cout=cout, n=n)
    passes = _VARIANT_PASSES.get(variant)
    peak = H100["peak_int8"] if passes else H100["peak_bf16"]
    compute_s = 2.0 * counts["mults"] * (passes or 1) / peak
    memory_s = conv_hbm_bytes(path, kh=kh, kw=kw, stride=stride, h=h,
                              cin=cin, cout=cout, variant=variant, n=n,
                              fusion=fusion,
                              handoff_in=handoff_in) / H100["hbm_bw"]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "roofline_s": max(compute_s, memory_s), **counts}
