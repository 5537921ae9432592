"""Implicit-GEMM integer conv: schedules, CUDA kernel wrapper, plain version.

Replaces the TPU kernel ``repro/kernels/conv2d/implicit_gemm.py:
_implicit_kernel`` (``conv2d_implicit_raw``) in its integer variants with
the ``bias_relu`` epilogue.  The GEMM is M = output pixels, K = kh*kw*cin,
N = cout, with no patch matrix in device memory: activations are quantized
per PATCH as they are gathered, the three int32 limb partials fold into an
f32 group sum at the recombine-group boundaries (:func:`recombine_schedule`,
:func:`group_spans`), and the epilogue is ``fma(sum, s_patch * s_ch, b)``.
The CUDA source is ``repro_torch/csrc/implicit_conv.cu``.

The pooled epilogue, the int16 handoff input and the float variants of the
TPU kernel are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.substrate import (dequant_epilogue, kom_qmax,
                                        limb_partials, limb_recombine,
                                        quantize_values)
from repro_torch.kernels import build

from .conv2d import int_accum_bound, limb_term_bound

INT_VARIANTS = ("karatsuba", "schoolbook")

NAME = "implicit_conv"
_ARGTYPES = {"implicit_conv_launch": [ctypes.c_void_p] * 6
             + [ctypes.c_int] * 16 + [ctypes.c_void_p]}


def max_cin_block(kh: int, kw: int, *, variant: str, base_bits: int) -> int:
    """Largest bk whose single K-step (kh*kw*bk terms) cannot wrap int32."""
    return max((2**31 - 1) // (limb_term_bound(variant, base_bits) * kh * kw),
               1)


def recombine_schedule(kh: int, kw: int, cin: int, block_cin: int, *,
                       variant: str, base_bits: int) -> int:
    """K steps (of ``block_cin`` channels) between int32 -> f32 folds.

    One fold on the last step when the whole contraction fits int32;
    otherwise every ``floor((2^31-1) / (term*kh*kw*block_cin))`` steps.
    """
    nk = -(-cin // block_cin)
    if int_accum_bound(kh, kw, cin, variant=variant,
                       base_bits=base_bits) < 2**31:
        return nk
    every = (2**31 - 1) // (limb_term_bound(variant, base_bits)
                            * kh * kw * block_cin)
    if every < 1:
        raise ValueError(
            f"block_cin={block_cin} too wide for wrap-free int32 groups at "
            f"kh*kw={kh * kw}: need block_cin <= "
            f"{max_cin_block(kh, kw, variant=variant, base_bits=base_bits)}")
    return min(every, nk)


def group_spans(cin: int, block_cin: int, fold_every: int) -> tuple:
    """Channel spans [(c0, c1), ...] of the recombine groups."""
    step = fold_every * block_cin
    return tuple((c0, min(c0 + step, cin)) for c0 in range(0, cin, step))


def _check(x, w_vals, ascale, wscale, bias, stride, out_hw, span_c,
           variant, base_bits):
    if variant not in INT_VARIANTS:
        raise ValueError(f"integer variants only, got {variant!r}")
    n, _, _, cin = x.shape
    kh, kw, wcin, cout = w_vals.shape
    ho, wo = out_hw
    if wcin != cin:
        raise ValueError(f"weight cin {wcin} != input cin {cin}")
    if tuple(ascale.shape) != (n, ho, wo):
        raise ValueError(f"ascale must be {(n, ho, wo)}, got "
                         f"{tuple(ascale.shape)}")
    if tuple(wscale.shape) != (cout,) or (
            bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError("wscale and bias must have shape (cout,)")
    if span_c < 1 or limb_term_bound(variant, base_bits) * kh * kw \
            * min(span_c, cin) >= 2**31:
        raise ValueError(f"recombine group of {span_c} channels wraps int32")
    if stride < 1:
        raise ValueError(f"bad stride {stride}")


def conv2d_implicit_raw_plain(x, w_vals, ascale, wscale, bias=None, *,
                              stride: int, pads: tuple, out_hw: tuple,
                              span_c: int, variant: str, base_bits: int
                              ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    Per-tap strided slices of the zero-padded input, per-patch quantization,
    exact int32 limb partials per recombine group, one f32 recombine per
    group, groups summed in order, then ``fma(sum, s_patch * s_ch, b)``.
    """
    _check(x, w_vals, ascale, wscale, bias, stride, out_hw, span_c,
           variant, base_bits)
    n, h, w, cin = x.shape
    kh, kw, _, cout = w_vals.shape
    ho, wo = out_hw
    pad_t, pad_l = pads
    need_h, need_w = (ho - 1) * stride + kh, (wo - 1) * stride + kw
    xp = F.pad(x.to(torch.float32),
               (0, 0, pad_l, max(need_w - w - pad_l, 0),
                pad_t, max(need_h - h - pad_t, 0)))
    qmax = kom_qmax(base_bits)
    s4 = ascale.to(torch.float32)[..., None]
    acc = None
    for c0 in range(0, cin, span_c):
        c1 = min(c0 + span_c, cin)
        p_hh = p_mid = p_ll = None
        for dy in range(kh):
            for dx in range(kw):
                rows = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                          dx:dx + (wo - 1) * stride + 1:stride, c0:c1]
                q = quantize_values(rows, s4, qmax)
                hh, mid, ll = limb_partials(q, w_vals[dy, dx, c0:c1],
                                            variant=variant,
                                            base_bits=base_bits)
                if p_hh is None:
                    p_hh, p_mid, p_ll = hh, mid, ll
                else:
                    p_hh, p_mid, p_ll = p_hh + hh, p_mid + mid, p_ll + ll
        g = limb_recombine(p_hh, p_mid, p_ll, base_bits=base_bits)
        acc = g if acc is None else acc + g
    t = s4 * wscale.to(torch.float32)
    return dequant_epilogue(acc, t, None if bias is None
                            else bias.to(torch.float32))


def conv2d_implicit_raw(x, w_vals, ascale, wscale, bias=None, *,
                        stride: int, pads: tuple, out_hw: tuple, span_c: int,
                        variant: str, base_bits: int) -> torch.Tensor:
    """Integer implicit-GEMM conv with the fused dequant(+bias) epilogue.

    ``x`` (n, h, w, cin) f32 UNPADDED NHWC (``pads`` = (top, left) zero
    padding; bottom/right follow from ``out_hw``); ``w_vals`` (kh, kw, cin,
    cout) integers; ``ascale`` (n, ho, wo) per-patch scales; ``wscale``
    (cout,); ``bias`` (cout,) or None; ``span_c`` channels per recombine
    group.  Returns (n, ho, wo, cout) f32.  CUDA tensors run the kernel,
    CPU tensors :func:`conv2d_implicit_raw_plain`.
    """
    kw_ = dict(stride=stride, pads=pads, out_hw=out_hw, span_c=span_c,
               variant=variant, base_bits=base_bits)
    if not build.use_kernel(x):
        return conv2d_implicit_raw_plain(x, w_vals, ascale, wscale, bias,
                                         **kw_)
    _check(x, w_vals, ascale, wscale, bias, stride, out_hw, span_c, variant,
           base_bits)
    dev = x.device
    n, h, w, cin = x.shape
    kh, kw, _, cout = w_vals.shape
    ho, wo = out_hw
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    xc, asc, wsc, bs = f32(x), f32(ascale), f32(wscale), f32(bias)
    wv = w_vals.to(device=dev, dtype=torch.int16).contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    code = lib.implicit_conv_launch(
        xc.data_ptr(), wv.data_ptr(), asc.data_ptr(), wsc.data_ptr(),
        build.ptr(bs), out.data_ptr(), n, h, w, cin, cout, kh, kw, stride,
        pads[0], pads[1], ho, wo, span_c, kom_qmax(base_bits), base_bits,
        int(variant == "karatsuba"), build.stream_ptr(xc))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
