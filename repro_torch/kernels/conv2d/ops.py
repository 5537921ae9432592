"""Public integer conv wrappers: implicit GEMM and Winograd F(2x2, 3x3).

The port of the integer, ``bias_relu`` halves of ``repro/kernels/conv2d/
ops.py``: scale plans computed here in PyTorch (per-patch, or per-tile on
Winograd-eligible layers), the core on the CUDA kernel (plain version on
the CPU), bias inside the kernel's epilogue as ``fma(raw, t, b)`` and ReLU
after it -- which is what the reference's jitted forward computes.

Tiles are the kernels' own; of a plan's ``block`` only the implicit
engine's Cin chunk ``bk`` is read, because it sets the recombine groups on
layers too deep for one int32 accumulation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.substrate import (QWeight, activation_scale, conv_pads,
                                        kom_qmax, not_ported,
                                        quantize_weight)

from .implicit_gemm import (INT_VARIANTS, conv2d_implicit_raw, group_spans,
                            max_cin_block, recombine_schedule)
from .winograd import (WINOGRAD_OUTPUT_SCALE, channel_absmax,
                       conv2d_winograd_raw, tile_scales_from_cmax,
                       tile_scales_upsampled, winograd_accum_bound,
                       winograd_scale_eligible, winograd_weight_planes)


def _activate(out: torch.Tensor, activation) -> torch.Tensor:
    if activation == "relu":
        return torch.relu_(out)
    if activation is not None:
        raise ValueError(f"unknown activation: {activation!r}")
    return out


def _padded_cmax(x, pads):
    (pt, pb), (pl, pr) = pads
    return F.pad(channel_absmax(x), (pl, pr, pt, pb))


def patch_scales(cmax_p: torch.Tensor, kh: int, kw: int, stride: int,
                 qmax: int) -> torch.Tensor:
    """Per-PATCH scales: the windowed max of the padded channel abs-max."""
    amax = F.max_pool2d(cmax_p[:, None], kernel_size=(kh, kw),
                        stride=stride)[:, 0]
    return activation_scale(amax, qmax)


def conv2d_implicit(x: torch.Tensor, w, *, stride: int = 1,
                    padding: str = "SAME", variant: str = "karatsuba",
                    base_bits: int = 7, bias: torch.Tensor | None = None,
                    activation: str | None = None, block=None,
                    fold_every: int | None = None) -> torch.Tensor:
    """NHWC integer conv as an implicit GEMM: no patch matrix in memory.

    ``w`` is a :class:`QWeight` or a float HWIO weight (quantized here with
    the same per-output-channel rule).  ``block=(bm, bc, bk)``: only ``bk``
    is read (default: the widest wrap-free chunk, capped at Cin);
    ``fold_every`` overrides the recombine schedule (tests).
    """
    if variant not in INT_VARIANTS:
        raise not_ported(f"the implicit engine's {variant!r} variant",
                         "Queue 2 item 2: the implicit kernel's float "
                         "variants")
    if not isinstance(w, QWeight):
        w = quantize_weight(w, base_bits=base_bits)
    base_bits = w.base_bits
    kh, kw, cin, _ = w.shape
    qmax = kom_qmax(base_bits)
    x = x.to(torch.float32)
    ho, wo, pads = conv_pads(x.shape[1], x.shape[2], kh, kw, stride,
                             padding)
    if block is not None:
        bk = block[2]
    else:
        bk = max_cin_block(kh, kw, variant=variant, base_bits=base_bits)
    bk = min(bk, cin)
    if fold_every is None:
        fold_every = recombine_schedule(kh, kw, cin, bk, variant=variant,
                                        base_bits=base_bits)
    span_c = group_spans(cin, bk, fold_every)[0][1]
    cmax_p = _padded_cmax(x, pads)
    if winograd_scale_eligible(kh, kw, stride, cin, variant=variant,
                               base_bits=base_bits):
        s_tile = tile_scales_from_cmax(cmax_p, qmax, -(-ho // 2), -(-wo // 2))
        ascale = tile_scales_upsampled(s_tile, ho, wo)
    else:
        ascale = patch_scales(cmax_p, kh, kw, stride, qmax)[:, :ho, :wo]
    out = conv2d_implicit_raw(
        x, w.values, ascale.contiguous(), w.scale, bias, stride=stride,
        pads=(pads[0][0], pads[1][0]), out_hw=(ho, wo), span_c=span_c,
        variant=variant, base_bits=base_bits)
    return _activate(out, activation)


def _weight_planes(w: QWeight):
    """The Winograd weight planes of a cached weight, computed once."""
    planes = w.derived.get("winograd")
    if planes is None:
        planes = winograd_weight_planes(w.values, w.base_bits)
        w.derived["winograd"] = planes
    return planes


def conv2d_winograd(x: torch.Tensor, w, *, stride: int = 1,
                    padding: str = "SAME", variant: str = "karatsuba",
                    base_bits: int = 7, bias: torch.Tensor | None = None,
                    activation: str | None = None) -> torch.Tensor:
    """NHWC integer conv through F(2x2, 3x3), epilogue fused.

    Exact-or-reroute: non-3x3 kernels, strides != 1 and layers past
    :func:`winograd_accum_bound` go to :func:`conv2d_implicit`.
    """
    if variant not in INT_VARIANTS:
        raise ValueError(
            f"conv2d_winograd cannot run variant {variant!r}: the Winograd "
            "transforms live in the quantized-limb integer domain")
    if not isinstance(w, QWeight):
        w = quantize_weight(w, base_bits=base_bits)
    base_bits = w.base_bits
    kh, kw, cin, _ = w.shape
    if (kh, kw) != (3, 3) or stride != 1 or winograd_accum_bound(
            cin, variant=variant, base_bits=base_bits) >= 2**31:
        return conv2d_implicit(x, w, stride=stride, padding=padding,
                               variant=variant, base_bits=base_bits,
                               bias=bias, activation=activation)
    x = x.to(torch.float32)
    ho, wo, pads = conv_pads(x.shape[1], x.shape[2], 3, 3, 1, padding)
    th, tw = -(-ho // 2), -(-wo // 2)
    s_tile = tile_scales_from_cmax(_padded_cmax(x, pads), kom_qmax(base_bits),
                                   th, tw)
    uh, ul = _weight_planes(w)
    wscale4 = w.scale * float(np.float32(1.0 / WINOGRAD_OUTPUT_SCALE))
    out = conv2d_winograd_raw(
        x, uh, ul, s_tile.contiguous(), wscale4, bias,
        pads=(pads[0][0], pads[1][0]), out_hw=(ho, wo), variant=variant,
        base_bits=base_bits)
    return _activate(out, activation)
