"""Public conv wrappers: implicit GEMM, systolic direct conv, Winograd.

The port of ``repro/kernels/conv2d/ops.py``: scale plans computed here in
PyTorch (per-patch, or per-tile on Winograd-eligible layers), the core on
the CUDA kernel (plain version on the CPU), bias inside the kernel's
epilogue as ``fma(raw, t, b)`` and ReLU after it -- which is what the
reference's jitted forward computes.  :func:`conv2d_systolic` quantizes per
SAMPLE instead and rounds its epilogue as ``fl(fl(raw * t) + b)``; the
float variants of :func:`conv2d_implicit` add the bias after their core.

The implicit engine's fused dataflow: ``pool=`` folds the following
maxpool into the kernel's epilogue (2x2/s2 VALID; other windows pool after
the core, in the same call), ``quantize_next=`` hands the pooled output to
the next 3x3/s1/SAME layer through :func:`handoff_quantize`, and a
:class:`~repro_torch.core.substrate.QActivation` input runs the kernel's
handoff variant.

Tiles are the kernels' own; of a plan's ``block`` only the implicit
engine's Cin chunk ``bk`` is read: it sets the recombine groups on layers
too deep for one int32 accumulation, and the handoff consumer's f32 order.
Without a block the chunk comes from the tuner
(:func:`~repro_torch.core.tuning.resolve_block`, keyed by the input's
device type).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.substrate import (QActivation, QWeight,
                                        activation_scale, conv_pads,
                                        dequantize_weight, kom_qmax,
                                        quantize_symmetric, quantize_weight)
from repro_torch.core.systolic import pool2d

from .conv2d import (NATIVE_NAME, SYSTOLIC_VARIANTS, conv2d_systolic_raw,
                     int_accum_bound)
from .implicit_gemm import (FLOAT_PASSES, INT_VARIANTS, KERNEL_POOLS,
                            cell_scales, conv2d_implicit_float_raw,
                            conv2d_implicit_handoff_raw, conv2d_implicit_raw,
                            group_spans, recombine_schedule)
from .winograd import (WINOGRAD_OUTPUT_SCALE, channel_absmax,
                       conv2d_winograd_raw, tile_scale_grid,
                       tile_scales_from_cmax, tile_scales_upsampled,
                       winograd_accum_bound, winograd_scale_eligible,
                       winograd_weight_planes)


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


def handoff_quantize(x: torch.Tensor, *, base_bits: int) -> QActivation:
    """Quantize an activation ONCE per pixel for a 3x3/s1/SAME consumer.

    The producer half of the ``pool_quant`` handoff, shared by the fused
    epilogue and the unfused pipeline: SAME-pad for the consumer, build
    its 4x4/s2 tile scale grid (the jitted rule ``amax * f32(1/qmax)``),
    round each cell scale UP to a power of two (``frexp``: 2^e is the
    smallest power of two >= the scale, and an exact power of two doubles,
    as in the reference), then quantize each PADDED pixel with its cell's
    scale: true division, round half to even, clip, int16.  Padding pixels
    quantize to 0.
    """
    qmax = kom_qmax(base_bits)
    n, h, w, c = x.shape
    _, _, ((pt, pb), (pl, pr)) = conv_pads(h, w, 3, 3, 1, "SAME")
    xp = F.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    grid = tile_scale_grid(xp, qmax, -(-h // 2), -(-w // 2))
    _, e = torch.frexp(grid)
    grid = torch.ldexp(torch.ones_like(grid), e)
    cs = cell_scales(grid, xp.shape[1], xp.shape[2])
    q = torch.clamp(torch.round(xp / cs[..., None]), -qmax, qmax)
    return QActivation(values=q.to(torch.int16), scale=grid,
                       base_bits=base_bits, h=h, w=w)


def _pool_tuple(pool):
    if pool is None:
        return None
    return (int(pool[0]), int(pool[1]),
            pool[2] if len(pool) > 2 else "VALID")


def _check_handoff_input(x: QActivation, w, stride, padding, variant):
    if variant not in INT_VARIANTS:
        raise ValueError("QActivation input requires an integer limb variant")
    if not isinstance(w, QWeight):
        raise ValueError("QActivation input requires a cached QWeight (the "
                         "handoff is a serving-path contract)")
    if (w.shape[0], w.shape[1], stride, padding) != (3, 3, 1, "SAME"):
        raise ValueError(
            "QActivation was quantized for a 3x3/s1/SAME consumer; got "
            f"k={w.shape[0]}x{w.shape[1]} s{stride} {padding}")
    if x.base_bits != w.base_bits:
        raise ValueError(
            f"handoff base_bits {x.base_bits} != weight base_bits "
            f"{w.base_bits}: producer and consumer must share a policy")


def conv2d_implicit(x, w, *, stride: int = 1, padding: str = "SAME",
                    variant: str = "karatsuba", base_bits: int = 7,
                    bias: torch.Tensor | None = None,
                    activation: str | None = None, block=None,
                    fold_every: int | None = None, pool=None,
                    quantize_next: int | None = None):
    """NHWC conv as an implicit GEMM: no patch matrix in memory.

    ``variant``: ``karatsuba``/``schoolbook`` (the limb substrate) or the
    float variants ``native`` (f32), ``bf16x3``/``bf16x6`` (bf16 limb
    passes).  Integer variants take a :class:`QWeight` or a float HWIO
    weight (quantized here with the same per-output-channel rule); float
    variants dequantize a QWeight.  ``block=(bm, bc, bk)``: only ``bk`` is
    read by the integer variants (default: the tuner's
    :func:`~repro_torch.core.tuning.resolve_block`, without a cache entry
    the widest wrap-free chunk, capped at Cin); ``fold_every`` overrides
    the recombine schedule (tests).

    ``pool=(pw, ps[, ppad])`` maxpools the output inside the call -- in the
    integer kernel's epilogue for 2x2/s2 VALID, after the core for any
    other window or variant -- with bias and ReLU on the pooled tensor
    (max is exact selection, so this equals pooling after them).
    ``quantize_next=b`` returns the (pooled) result as a
    :class:`QActivation` through :func:`handoff_quantize`.  A QActivation
    ``x`` is the consumer side: a 3x3/s1/SAME layer under an integer
    variant with a cached QWeight.
    """
    pool = _pool_tuple(pool)
    if variant in FLOAT_PASSES:
        if isinstance(x, QActivation):
            raise ValueError(
                "QActivation input requires an integer limb variant")
        kernel_pool = None
        kbias = bias if pool is None else None
        if isinstance(w, QWeight):
            w = dequantize_weight(w)
        x = x.to(torch.float32)
        kh, kw = w.shape[:2]
        ho, wo, pads = conv_pads(x.shape[1], x.shape[2], kh, kw, stride,
                                 padding)
        out = conv2d_implicit_float_raw(
            x, w, kbias, stride=stride, pads=(pads[0][0], pads[1][0]),
            out_hw=(ho, wo), variant=variant)
    elif variant in INT_VARIANTS:
        out, kernel_pool, kbias = _implicit_int_core(
            x, w, stride=stride, padding=padding, variant=variant,
            base_bits=base_bits, bias=bias, block=block,
            fold_every=fold_every, pool=pool)
    else:
        raise ValueError(f"unknown implicit variant: {variant!r}")
    if pool is not None and kernel_pool is None:
        out = pool2d(out, window=pool[0], stride=pool[1], kind="max",
                     padding=pool[2])
    if bias is not None and kbias is None:
        out = out + bias.to(torch.float32)
    out = _activate(out, activation)
    if quantize_next is not None:
        return handoff_quantize(out, base_bits=int(quantize_next))
    return out


def _implicit_int_core(x, w, *, stride, padding, variant, base_bits, bias,
                       block, fold_every, pool):
    """The integer implicit conv before the wrapper's pool/bias/ReLU tail.

    Returns (out, the pool the kernel fused or None, the bias the kernel
    applied or None).
    """
    handoff_in = isinstance(x, QActivation)
    if handoff_in:
        _check_handoff_input(x, w, stride, padding, variant)
    if not isinstance(w, QWeight):
        w = quantize_weight(w, base_bits=base_bits)
    base_bits = w.base_bits
    kh, kw, cin, cout = w.shape
    qmax = kom_qmax(base_bits)
    if block is not None:
        bk = block[2]
    else:
        from repro_torch.core.tuning import resolve_block
        dev = x.values.device if handoff_in else x.device
        bk = resolve_block("implicit", kh=kh, kw=kw, stride=stride,
                           h=x.shape[1], cin=cin, cout=cout, variant=variant,
                           base_bits=base_bits, backend=dev.type)[2]
    bk = min(bk, cin)
    kernel_pool = None
    if pool is not None and pool[2] == "VALID" and pool[:2] in KERNEL_POOLS:
        kernel_pool = pool[:2]
    # Bias rides the kernel's epilogue unless the pool runs after the core.
    kbias = bias if pool is None or kernel_pool is not None else None
    if handoff_in:
        out = conv2d_implicit_handoff_raw(
            x.values, x.scale, w.values, w.scale, kbias, bk=bk,
            variant=variant, base_bits=base_bits, pool=kernel_pool)
        return out, kernel_pool, kbias
    x = x.to(torch.float32)
    ho, wo, pads = conv_pads(x.shape[1], x.shape[2], kh, kw, stride,
                             padding)
    if fold_every is None:
        fold_every = recombine_schedule(kh, kw, cin, bk, variant=variant,
                                        base_bits=base_bits)
    span_c = group_spans(cin, bk, fold_every)[0][1]
    cmax_p = _padded_cmax(x, pads)
    if winograd_scale_eligible(kh, kw, stride, cin, variant=variant,
                               base_bits=base_bits):
        s_tile = tile_scales_from_cmax(cmax_p, qmax, -(-ho // 2),
                                       -(-wo // 2))
        ascale = tile_scales_upsampled(s_tile, ho, wo)
    else:
        ascale = patch_scales(cmax_p, kh, kw, stride, qmax)[:, :ho, :wo]
    out = conv2d_implicit_raw(
        x, w.values, ascale.contiguous(), w.scale, kbias, stride=stride,
        pads=(pads[0][0], pads[1][0]), out_hw=(ho, wo), span_c=span_c,
        variant=variant, base_bits=base_bits, pool=kernel_pool)
    return out, kernel_pool, kbias


def conv2d_systolic(x: torch.Tensor, w, *, stride: int = 1,
                    padding: str = "SAME", variant: str = "native",
                    base_bits: int = 7, bias: torch.Tensor | None = None,
                    activation: str | None = None) -> torch.Tensor:
    """NHWC conv through the systolic engine, epilogue fused.

    ``variant='native'``: f32 taps, float weight only (a QWeight raises
    TypeError), on the implicit engine's native kernel -- the same function
    -- counted as ``systolic_conv_native``.  ``karatsuba`` (alias ``kom``)
    / ``schoolbook``: the input is quantized per SAMPLE --
    ``quantize_symmetric(x, axis=0)``, the jitted scale rule, before
    padding, so the padding is integer zeros -- and ``w`` is a QWeight or
    a float HWIO weight quantized here per output channel.  A request's
    integer logits therefore do not depend on its batch-mates.  The
    dequant product ``s_sample * s_ch`` is an (n, cout) operand of the
    kernel; the bias is added after it and the ReLU after that.  Layers
    whose ``int_accum_bound`` reaches 2^31 reroute to
    :func:`conv2d_implicit`, whose recombine schedule is wrap-free at any
    depth.
    """
    if variant == "kom":
        variant = "karatsuba"
    if variant not in SYSTOLIC_VARIANTS:
        raise ValueError(f"unknown systolic variant: {variant!r}")
    kh, kw, cin, _ = w.shape
    if variant == "native":
        if isinstance(w, QWeight):
            raise TypeError("variant='native' expects a float weight, not "
                            "QWeight")
    else:
        if not isinstance(w, QWeight):
            w = quantize_weight(w, base_bits=base_bits)
        base_bits = w.base_bits
        if int_accum_bound(kh, kw, cin, variant=variant,
                           base_bits=base_bits) >= 2**31:
            return conv2d_implicit(x, w, stride=stride, padding=padding,
                                   variant=variant, base_bits=base_bits,
                                   bias=bias, activation=activation)
    x = x.to(torch.float32)
    n = x.shape[0]
    ho, wo, pads = conv_pads(x.shape[1], x.shape[2], kh, kw, stride, padding)
    geom = dict(stride=stride, pads=(pads[0][0], pads[1][0]), out_hw=(ho, wo))
    if variant == "native":
        out = conv2d_implicit_float_raw(x, w, bias, variant="native",
                                        counter=NATIVE_NAME, **geom)
    else:
        qx = quantize_symmetric(x, base_bits=base_bits, axis=0)
        scale = qx.scale.reshape(n, 1) * w.scale.to(torch.float32)[None, :]
        out = conv2d_systolic_raw(
            qx.values.to(torch.int16), w.values, scale, bias,
            variant=variant, base_bits=base_bits, **geom)
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
