"""Roofline floors on one NVIDIA H100: one conv layer (the port of
``repro.analysis.roofline``'s ``conv_mult_counts`` / ``conv_layer_roofline``),
the two attention kernels (:func:`attention_roofline`,
:func:`decode_attention_roofline`) and the chunkwise mLSTM
(:func:`mlstm_chunk_roofline`).

Priced with the H100 SXM's published dense peaks (NVIDIA data sheet):
int8 tensor-core operations 1,979 TOP/s, bf16 989 TFLOP/s, f32 on the CUDA
cores 67 TFLOP/s, HBM3 3.35 TB/s, all at the 700 W power limit.  No TPU
constant is used here.  Each variant's passes are priced at the peak of
the type they multiply (:func:`variant_peak`): the integer limb passes at
the int8 rate, the bf16x3/bf16x6 limb passes and ``native_bf16``'s bf16
products at the bf16 rate, native f32 at the f32 rate.  The port's
kernels run their passes on the CUDA cores (``__dp4a``, ``__fmaf_rn``),
far below the tensor-core peaks, so the compute term is a floor, not a
prediction; it is what the explorer's ``--model-only`` mode ranks by, and
what ``chip_smoke.py`` reports as each kernel's bound.
"""
from __future__ import annotations

from typing import Dict

#: NVIDIA H100 SXM, dense, published peaks at 700 W.
H100 = {
    "peak_int8": 1979e12,   # int8 tensor-core operations per second
    "peak_bf16": 989e12,    # bf16 tensor-core FLOP per second
    "peak_fp32": 67e12,     # f32 FLOP per second on the CUDA cores
    "hbm_bw": 3.35e12,      # HBM3 bytes per second
}

#: Narrow passes one wide multiply costs per variant: int8 passes of the
#: limb variants, bf16 passes of the emulation schedules, one f32 product
#: (``native``) or one bf16 product (``native_bf16``).
VARIANT_PASSES = {"karatsuba": 3, "schoolbook": 4, "bf16x3": 3, "bf16x6": 6,
                  "native": 1, "native_bf16": 1}


def variant_peak(variant: str) -> float:
    """Operations per second of the type ``variant``'s passes multiply."""
    if variant in ("karatsuba", "schoolbook"):
        return H100["peak_int8"]
    if variant.startswith("bf16") or variant == "native_bf16":
        return H100["peak_bf16"]
    if variant == "native":
        return H100["peak_fp32"]
    raise ValueError(f"unknown variant {variant!r}")


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

    compute_s: 2 operations per wide multiply times the variant's pass
    count (:data:`VARIANT_PASSES`) at its type's peak (:func:`variant_peak`).
    memory_s: the port's modeled device-memory traffic
    (:func:`repro_torch.core.tuning.conv_hbm_bytes`) at the HBM rate.  The
    floor is their max; ``fusion``/``handoff_in`` move only memory_s.
    """
    from repro_torch.core.tuning import conv_hbm_bytes

    counts = conv_mult_counts(path, kh=kh, kw=kw, stride=stride, h=h,
                              cin=cin, cout=cout, n=n)
    compute_s = (2.0 * counts["mults"] * VARIANT_PASSES[variant]
                 / variant_peak(variant))
    memory_s = conv_hbm_bytes(path, kh=kh, kw=kw, stride=stride, h=h,
                              cin=cin, cout=cout, variant=variant, n=n,
                              fusion=fusion,
                              handoff_in=handoff_in) / H100["hbm_bw"]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "roofline_s": max(compute_s, memory_s), **counts}


def _live_pairs(sq, skv, *, causal, window, q_offset) -> int:
    """Number of (query, key) pairs the mask leaves live."""
    live = 0
    for i in range(sq):
        p = i + q_offset
        hi = min(p, skv - 1) if causal else skv - 1
        lo = max(0, p - window + 1) if window is not None else 0
        live += max(0, hi - lo + 1)
    return live


def attention_roofline(*, b, hq, hkv, sq, skv, dh, causal=True, window=None,
                       q_offset=0, itemsize=4) -> Dict[str, float]:
    """H100 floor of one flash-attention call (seconds).

    compute_s: ``4*b*hq*sq*skv*dh`` FLOPs (QK^T and PV) times the unmasked
    share of the (sq, skv) pairs, at the f32 CUDA-core peak (the kernel's
    math is f32).  memory_s: q, k, v read once and o written once, at the
    HBM rate.
    """
    share = _live_pairs(sq, skv, causal=causal, window=window,
                        q_offset=q_offset) / float(sq * skv)
    flops = 4.0 * b * hq * sq * skv * dh * share
    nbytes = float(itemsize * dh * (2 * b * hq * sq + 2 * b * hkv * skv))
    compute_s = flops / H100["peak_fp32"]
    memory_s = nbytes / H100["hbm_bw"]
    return {"flops": flops, "bytes": nbytes, "live_share": share,
            "compute_s": compute_s, "memory_s": memory_s,
            "roofline_s": max(compute_s, memory_s)}


def decode_attention_roofline(*, b, hq, hkv, S, dh, pos,
                              itemsize=4) -> Dict[str, float]:
    """H100 floor of one flash-decode call (seconds): the K/V bytes of the
    ``pos + 1`` valid keys read once (plus q and o), against ``4*b*hq*(pos+1)
    *dh`` FLOPs at the f32 peak."""
    n = min(pos + 1, S) if pos >= 0 else S
    flops = 4.0 * b * hq * n * dh
    nbytes = float(itemsize * dh * (2 * b * hkv * n + 2 * b * hq))
    compute_s = flops / H100["peak_fp32"]
    memory_s = nbytes / H100["hbm_bw"]
    return {"flops": flops, "bytes": nbytes, "compute_s": compute_s,
            "memory_s": memory_s, "roofline_s": max(compute_s, memory_s)}


def mlstm_chunk_roofline(*, b, h, s, dh, chunk, itemsize=4,
                         dv_tile: int = 64) -> Dict[str, float]:
    """H100 floor of one chunkwise-mLSTM call on ``s`` (padded) tokens
    (seconds).

    ``flops``: what the function needs, per (b, h, chunk of C): the causal
    scores ``2 * C(C+1)/2 * dh`` and y_intra the same, y_inter and the
    state update ``2*C*dh*dh`` each, the normalizer's ``q . n`` and ``k^T
    w`` ``2*C*dh`` each; at the f32 CUDA-core peak (the kernel's math is
    f32 for bf16 inputs too).  ``flops_dv_split``: what the CUDA kernel
    issues, the full (C x C) score tile and the normalizer recomputed by
    each of its ``ceil(dh / dv_tile)`` dv tiles.  memory_s: q, k, v read
    once (``itemsize``), the two f32 gates read once and the f32 y written
    once, at the HBM rate.  The bound is from ``flops``.
    """
    c = chunk
    nb = b * h * (s // c)
    tiles = -(-dh // dv_tile)
    live = c * (c + 1) / 2.0
    inter = 2.0 * 2 * c * dh * dh          # y_inter + the state update
    norm = 2.0 * 2 * c * dh                # q . n and k^T w
    flops = nb * (2.0 * 2 * live * dh + inter + norm)
    flops_split = nb * (tiles * 2.0 * c * c * dh + 2.0 * c * c * dh + inter
                        + tiles * norm)
    nbytes = float(b * h * s * (3 * dh * itemsize + 2 * 4 + 4 * dh))
    compute_s = flops / H100["peak_fp32"]
    memory_s = nbytes / H100["hbm_bw"]
    return {"flops": flops, "flops_dv_split": flops_split, "bytes": nbytes,
            "compute_s": compute_s, "memory_s": memory_s,
            "roofline_s": max(compute_s, memory_s)}
