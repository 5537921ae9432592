"""The systolic direct conv: CUDA kernel wrapper, plain version, int32 bounds.

Replaces the TPU kernel ``repro/kernels/conv2d/conv2d.py:_conv_kernel``
(``conv2d_systolic_raw``), the paper's systolic conv engine: a direct NHWC
conv that contracts the kh*kw shifted views of the input over the whole
Cin.  Variants:

* ``karatsuba`` / ``schoolbook``: the input arrives quantized per sample
  (int16); THREE int32 limb accumulators run over all taps and Cin, one f32
  recombine follows, then the dequant ``fl(raw * scale[n, c])`` with the
  (n, cout) scale product, inside the kernel -- and the bias, when given,
  as a separate add after it, ``fl(fl(raw * t) + b)``: the reference
  multiplies inside its Pallas kernel and adds the bias outside it, so the
  two are never contracted.
* ``native``: f32 taps over the whole Cin.  That is the function of the
  implicit engine's ``native`` variant, so ``ops.conv2d_systolic`` runs
  that kernel (``implicit_gemm.conv2d_implicit_float_raw``) and counts its
  launches as :data:`NATIVE_NAME`; the raw wrapper here is integer only.

The CUDA source is ``repro_torch/csrc/systolic_conv.cu``.  The two bounds
below are what every limb conv engine's exactness model derives from: the
systolic engine needs :func:`int_accum_bound` below 2^31 (its wrapper
reroutes deeper layers to the implicit engine).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.substrate import limb_partials, limb_recombine
from repro_torch.kernels import build

SYSTOLIC_VARIANTS = ("karatsuba", "schoolbook", "native")

NAME = "systolic_conv"
#: Launch-counter name of the native variant (the implicit float kernel).
NATIVE_NAME = "systolic_conv_native"
_ARGTYPES = {"systolic_conv_launch": [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 14 + [ctypes.c_void_p]}


def limb_term_bound(variant: str, base_bits: int) -> int:
    """Worst-case |contribution| of ONE term to the widest int32 partial:
    Karatsuba's mid term 6*half^2, schoolbook's 2*half^2."""
    half = 1 << (base_bits - 1)
    return (6 if variant == "karatsuba" else 2) * half * half


def int_accum_bound(kh: int, kw: int, cin: int, *, variant: str,
                    base_bits: int) -> int:
    """Worst-case |value| of the widest int32 accumulator over kh*kw*cin."""
    return limb_term_bound(variant, base_bits) * kh * kw * cin


def _check(x, w, scale, bias, stride, out_hw, variant, base_bits):
    if variant not in ("karatsuba", "schoolbook"):
        raise ValueError(f"integer systolic variants only, got {variant!r}")
    n, _, _, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin:
        raise ValueError(f"weight cin {wcin} != input cin {cin}")
    if stride < 1 or min(out_hw) < 0:
        raise ValueError(f"bad stride {stride} or output {out_hw}")
    if int_accum_bound(kh, kw, cin, variant=variant,
                         base_bits=base_bits) >= 2**31:
        raise ValueError(
            f"int32 accumulator overflow: kh*kw*cin={kh * kw * cin} is too "
            "deep for one whole-contraction accumulation; route the layer "
            "through the implicit engine")
    if scale is not None and tuple(scale.shape) != (n, cout):
        raise ValueError(f"scale must have shape {(n, cout)}, got "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must have shape {(cout,)}")


def _tap_rows(xp, dy, dx, stride, ho, wo):
    return xp[:, dy:dy + (ho - 1) * stride + 1:stride,
              dx:dx + (wo - 1) * stride + 1:stride]


def conv2d_systolic_raw_plain(x, w, scale=None, bias=None, *, stride: int,
                              pads: tuple, out_hw: tuple, variant: str,
                              base_bits: int = 7) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    Per-tap exact int32 limb partials of the zero-padded input, summed
    over all taps, ONE f32 recombine, then ``raw * scale`` and ``+ bias``,
    each rounded on its own.
    """
    _check(x, w, scale, bias, stride, out_hw, variant, base_bits)
    n, h, wd, _ = x.shape
    kh, kw, _, _ = w.shape
    ho, wo = out_hw
    pad_t, pad_l = pads
    need_h, need_w = (ho - 1) * stride + kh, (wo - 1) * stride + kw
    padding = (0, 0, pad_l, max(need_w - wd - pad_l, 0),
               pad_t, max(need_h - h - pad_t, 0))
    xp = F.pad(x.to(torch.int32), padding)
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            p = limb_partials(_tap_rows(xp, dy, dx, stride, ho, wo),
                              w[dy, dx], variant=variant, base_bits=base_bits)
            acc = p if acc is None else tuple(s + t for s, t in zip(acc, p))
    out = limb_recombine(*acc, base_bits=base_bits)
    if scale is not None:
        return systolic_epilogue(
            out, scale.to(torch.float32)[:, None, None, :], bias)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


def systolic_epilogue(raw: torch.Tensor, t: torch.Tensor,
                      bias: torch.Tensor | None) -> torch.Tensor:
    """``fl(fl(raw * t) + b)``: the dequant product rounds on its own.

    The reference multiplies by the scale inside its Pallas kernel and adds
    the bias outside it, so under ``jax.jit`` the two never contract into
    an FMA (unlike the implicit and Winograd layers' epilogues).
    """
    out = raw * t
    return out if bias is None else out + bias.to(torch.float32)


def conv2d_systolic_raw(x, w, scale=None, bias=None, *, stride: int,
                        pads: tuple, out_hw: tuple, variant: str,
                        base_bits: int = 7) -> torch.Tensor:
    """Direct NHWC conv over every tap and the whole Cin.

    ``x`` (n, h, w, cin) UNPADDED int16 values quantized per sample, with
    ``pads`` = (top, left) zero padding (bottom/right follow from
    ``out_hw``); ``w`` (kh, kw, cin, cout) int16; ``scale`` (n, cout) f32,
    the per-sample x per-channel dequant product (None returns the raw
    recombined sums); ``bias`` (cout,) or None; ``variant`` ``karatsuba``
    or ``schoolbook``.  Returns (n, ho, wo, cout) f32.  CUDA tensors run
    the kernel, CPU tensors the plain version.
    """
    kw_ = dict(stride=stride, pads=pads, out_hw=out_hw, variant=variant,
               base_bits=base_bits)
    if not build.use_kernel(x):
        return conv2d_systolic_raw_plain(x, w, scale, bias, **kw_)
    _check(x, w, scale, bias, stride, out_hw, variant, base_bits)
    dev = x.device
    n, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = out_hw
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    bs = f32(bias)
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    geom = (n, h, wd, cin, cout, kh, kw, stride, pads[0], pads[1], ho, wo)
    xc = x.to(torch.int16).contiguous()
    wc = w.to(device=dev, dtype=torch.int16).contiguous()
    code = lib.systolic_conv_launch(
        xc.data_ptr(), wc.data_ptr(), build.ptr(f32(scale)), build.ptr(bs),
        out.data_ptr(), *geom, base_bits, int(variant == "karatsuba"),
        build.stream_ptr(xc))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
