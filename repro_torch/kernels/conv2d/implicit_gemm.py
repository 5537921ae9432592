"""Implicit-GEMM conv: schedules, CUDA kernel wrappers, plain versions.

Replaces the TPU kernel ``repro/kernels/conv2d/implicit_gemm.py:
_implicit_kernel`` (``conv2d_implicit_raw``).  The GEMM is M = output
pixels, K = kh*kw*cin, N = cout, with no patch matrix in device memory.
Three integer variants share one CUDA source
(``repro_torch/csrc/implicit_conv.cu``: int8 ``mma.sync`` passes on the
tensor cores over digit planes -- the weight's split once per call by a
first kernel, the gathered input's once per K step -- and a ``cp.async``
ring of both; its K walk is :func:`implicit_k_steps`), each with its
plain PyTorch version here:

* **bias_relu** (:func:`conv2d_implicit_raw_plain`): activations are
  quantized per PATCH as they are gathered, the three int32 limb partials
  fold into an f32 group sum at the recombine-group boundaries
  (:func:`recombine_schedule`, :func:`group_spans`), and the epilogue is
  ``fma(sum, s_patch * s_ch, b)``.
* **pool** (``pool=(2, 2)``): the same core, then the 2x2/s2 VALID maxpool
  of the dequantized tile before write-back: ``max(fl(sum * t)) + b`` --
  the max sits between the multiply and the bias add, so nothing is
  contracted.  Other windows pool after the core in the ops wrapper.
* **handoff** (:func:`conv2d_implicit_handoff_plain`): the input is a
  ``pool_quant`` producer's padded int16 pixels plus its power-of-two cell
  scale grid; nothing is quantized, and each (Cin chunk of ``bk``, tap)
  contributes one exact int32 limb dot, recombined at once, times the
  tap's cell scale (exact), added into the f32 sum -- chunk outer, taps
  inner; the epilogue is ``fma(sum, s_ch, b)``.

The float variants ``native``, ``bf16x3`` and ``bf16x6`` with the bias
epilogue (:func:`conv2d_implicit_float_raw`) run
``repro_torch/csrc/implicit_conv_float.cu``: tiles of the NHWC input and
the HWIO weight land by ``cp.async``; ``native`` runs a register-blocked
SIMT tile of f32 FMAs, ``bf16x3``/``bf16x6`` split input and weight once
into bf16 limb planes and run the pairs of the TPU kernel's
``_BF16_PAIRS`` as ``mma.sync`` bf16 products on the tensor cores.  Both
nest their f32 sums (:data:`FLOAT_MMA_K` and :data:`FLOAT_CHUNK` name the
order; the CPU tests emulate it).  Their plain version
(:func:`conv2d_implicit_float_plain`) is the port of the reference's
float mirror ``_stream_conv_float`` -- per-tap dots,
native f32 or bf16 limb passes -- with every product summed exactly
(:func:`~repro_torch.core.karatsuba.schedule_dot`) and rounded once, so
the kernel differs from it by its own f32 accumulation error alone.  The
systolic engine's ``native`` variant is the same function and runs the
same kernel, counted under its own name.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.karatsuba import schedule_dot
from repro_torch.core.substrate import (dequant_epilogue, kom_qmax,
                                        limb_partials, limb_recombine,
                                        quantize_values)
from repro_torch.kernels import build

from .conv2d import int_accum_bound, limb_term_bound

INT_VARIANTS = ("karatsuba", "schoolbook")
#: Float variants -> bf16 passes per product (1: native f32 FMAs).
FLOAT_PASSES = {"native": 1, "bf16x3": 3, "bf16x6": 6}

NAME = "implicit_conv"
#: Launch-counter names of the three variants (one library).
POOL_NAME, HANDOFF_NAME = "implicit_conv_pool", "implicit_conv_handoff"
#: Pool windows (window, stride) the kernel fuses; others pool after it.
KERNEL_POOLS = ((2, 2),)
_ARGTYPES = {"implicit_conv_launch": [ctypes.c_void_p] * 8
             + [ctypes.c_longlong] + [ctypes.c_int] * 20 + [ctypes.c_void_p],
             "implicit_conv_scratch": ([ctypes.c_int] * 6,
                                       ctypes.c_longlong)}
#: The float variants' library and each variant's launch-counter name.
FLOAT_LIB = "implicit_conv_float"
FLOAT_NAMES = {v: f"implicit_conv_{v}" for v in FLOAT_PASSES}
_FLOAT_ARGTYPES = {"implicit_conv_float_launch": [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] + [ctypes.c_int] * 13
                   + [ctypes.c_void_p],
                   "implicit_conv_float_scratch": ([ctypes.c_int] * 10,
                                                   ctypes.c_longlong),
                   "mma_probe_launch": [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_void_p]}
#: The float kernel's sum order (``csrc/implicit_conv_float.cu``): K walks
#: tap outer, Cin inner (a layer whose Cin is not a multiple of its tile
#: -- the stem -- folds the taps into one flat K).  ``native`` (route
#: ``simt``) chains one f32 FMA per product into a partial of at most
#: FLOAT_CHUNK["simt"] entries of one tap (of the flat K when folded); the
#: bf16 schedules (route ``mma``) sum each FLOAT_MMA_K-entry step's limb
#: pairs in one tensor-core fragment from zero and add it into a partial of
#: at most FLOAT_CHUNK["mma"] entries; each partial is added into its tap
#: group's total (where the grid is small, the taps split into groups --
#: one, three or nine of VGG16's 3 x 3 -- summed by a second kernel in
#: order).
FLOAT_MMA_K = 16
FLOAT_CHUNK = {"simt": 128, "mma": 512}


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


#: Input channels of one K step of the integer kernel: two int8 MMA depths.
IMPLICIT_STEP_C = 64


def implicit_k_steps(kh: int, kw: int, cin: int, span_c: int, *,
                     handoff: bool) -> list:
    """The integer kernel's K walk: ``(tap, c0, c1, folds)`` per step.

    A step is channels [c0, c1) of one tap, at most
    :data:`IMPLICIT_STEP_C` wide and cut at the end of its group of
    ``span_c`` channels, so no step straddles a group.  ``folds``: the
    step closes an int32 -> f32 fold.  Quantizing input: per group, the
    channel steps outer and the taps inner, one fold per group.  Handoff:
    per chunk of ``span_c`` (the plan's bk), the taps outer and the
    channel steps inner, one fold per (chunk, tap).  Within a fold the
    int32 sums are exact in any order; the folds come in the reference's
    order.
    """
    taps = kh * kw
    steps = []
    for g0 in range(0, cin, span_c):
        g1 = min(g0 + span_c, cin)
        subs = [(c0, min(c0 + IMPLICIT_STEP_C, g1))
                for c0 in range(g0, g1, IMPLICIT_STEP_C)]
        if handoff:
            for tap in range(taps):
                steps += [(tap, c0, c1, i == len(subs) - 1)
                          for i, (c0, c1) in enumerate(subs)]
        else:
            for i, (c0, c1) in enumerate(subs):
                steps += [(tap, c0, c1, i == len(subs) - 1
                           and tap == taps - 1) for tap in range(taps)]
    return steps


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


def _check_pool(pool):
    if pool is not None and tuple(pool) not in KERNEL_POOLS:
        raise ValueError(f"the kernel fuses pools {KERNEL_POOLS} only, got "
                         f"{tuple(pool)}: pool after the core instead")


def _pool_epilogue(acc, t, bias):
    """``max(fl(acc * t)) + b`` over the 2x2/s2 VALID windows."""
    out = F.max_pool2d((acc * t).permute(0, 3, 1, 2), 2, 2)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.contiguous()


def conv2d_implicit_raw_plain(x, w_vals, ascale, wscale, bias=None, *,
                              stride: int, pads: tuple, out_hw: tuple,
                              span_c: int, variant: str, base_bits: int,
                              pool=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device.

    Per-tap strided slices of the zero-padded input, per-patch quantization,
    exact int32 limb partials per recombine group, one f32 recombine per
    group, groups summed in order, then ``fma(sum, s_patch * s_ch, b)`` --
    or, with ``pool=(2, 2)``, ``max(fl(sum * t)) + b`` over the VALID pool
    windows.
    """
    _check(x, w_vals, ascale, wscale, bias, stride, out_hw, span_c,
           variant, base_bits)
    _check_pool(pool)
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
    if pool is not None:
        return _pool_epilogue(acc, t, bias)
    return dequant_epilogue(acc, t, None if bias is None
                            else bias.to(torch.float32))


def _check_handoff(q, grid, w_vals, wscale, bias, bk, variant, base_bits):
    if variant not in INT_VARIANTS:
        raise ValueError(f"integer variants only, got {variant!r}")
    n, hp, wp, cin = q.shape
    kh, kw, wcin, cout = w_vals.shape
    if (kh, kw) != (3, 3):
        raise ValueError("the handoff input feeds 3x3/s1/SAME convs only")
    if wcin != cin:
        raise ValueError(f"weight cin {wcin} != input cin {cin}")
    th, tw = -(-(hp - 2) // 2), -(-(wp - 2) // 2)
    if tuple(grid.shape) != (n, th, tw):
        raise ValueError(f"scale grid must be {(n, th, tw)}, got "
                         f"{tuple(grid.shape)}")
    if tuple(wscale.shape) != (cout,) or (
            bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError("wscale and bias must have shape (cout,)")
    if bk < 1 or limb_term_bound(variant, base_bits) * kh * kw * min(
            bk, cin) >= 2**31:
        raise ValueError(f"a handoff K step of {bk} channels wraps int32")


def cell_scales(grid: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Upsample the (n, th, tw) cell scale grid to per-PIXEL scales.

    Pixel (py, px) of the padded input takes the scale of 4x4/s2 cell
    ``(min(py//2, th-1), min(px//2, tw-1))``: every pixel lies inside its
    cell's amax window, so quantizing with it never clips past qmax.
    """
    th, tw = grid.shape[1], grid.shape[2]
    ri = torch.clamp(torch.arange(hp, device=grid.device) // 2, max=th - 1)
    ci = torch.clamp(torch.arange(wp, device=grid.device) // 2, max=tw - 1)
    return grid[:, ri][:, :, ci]


def conv2d_implicit_handoff_plain(q, grid, w_vals, wscale, bias=None, *,
                                  bk: int, variant: str, base_bits: int,
                                  pool=None) -> torch.Tensor:
    """The handoff variant's arithmetic in PyTorch, on any device.

    ``q`` (n, h+2, w+2, cin) int16 padded pixels and ``grid`` (n, th, tw)
    their cell scales (a :class:`~repro_torch.core.substrate.QActivation`'s
    fields); ``w_vals`` (3, 3, cin, cout).  For each Cin chunk of ``bk``
    and each tap in order: the exact int32 limb partials over the chunk,
    one recombine, times the tap's cell-scale plane (powers of two: exact),
    added into the f32 sum.  Epilogue ``fma(sum, s_ch, b)`` (the jitted
    reference contracts it), or ``max(fl(sum * s_ch)) + b`` with
    ``pool=(2, 2)``.
    """
    _check_handoff(q, grid, w_vals, wscale, bias, bk, variant, base_bits)
    _check_pool(pool)
    n, hp, wp, cin = q.shape
    ho, wo = hp - 2, wp - 2
    cs = cell_scales(grid.to(torch.float32), hp, wp)
    acc = None
    for c0 in range(0, cin, bk):
        c1 = min(c0 + bk, cin)
        for dy in range(3):
            for dx in range(3):
                rows = q[:, dy:dy + ho, dx:dx + wo, c0:c1]
                hh, mid, ll = limb_partials(rows, w_vals[dy, dx, c0:c1],
                                            variant=variant,
                                            base_bits=base_bits)
                rec = limb_recombine(hh, mid, ll, base_bits=base_bits)
                g = cs[:, dy:dy + ho, dx:dx + wo, None] * rec
                acc = g if acc is None else acc + g
    ws = wscale.to(torch.float32)
    if pool is not None:
        return _pool_epilogue(acc, ws, bias)
    return dequant_epilogue(acc, ws, None if bias is None
                            else bias.to(torch.float32))


def _launch(lib_args, out, name, *, cin, cout, kh, kw, span_c, karatsuba):
    """Launch the library's kernels (the weight's digit planes into a
    scratch the library sizes, then the conv), check the launch, count it
    once as ``name``."""
    lib = build.library(NAME, _ARGTYPES)
    nbytes = lib.implicit_conv_scratch(cin, cout, kh, kw, span_c,
                                       int(karatsuba))
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=out.device)
    code = lib.implicit_conv_launch(*lib_args[:7], scratch.data_ptr(),
                                    nbytes, *lib_args[7:])
    build.check_launch(lib, code, name)
    build.LAUNCHES[name] += 1
    return out


def conv2d_implicit_raw(x, w_vals, ascale, wscale, bias=None, *,
                        stride: int, pads: tuple, out_hw: tuple, span_c: int,
                        variant: str, base_bits: int,
                        pool=None) -> torch.Tensor:
    """Integer implicit-GEMM conv with the fused dequant(+bias) epilogue.

    ``x`` (n, h, w, cin) f32 UNPADDED NHWC (``pads`` = (top, left) zero
    padding; bottom/right follow from ``out_hw``); ``w_vals`` (kh, kw, cin,
    cout) integers; ``ascale`` (n, ho, wo) per-patch scales; ``wscale``
    (cout,); ``bias`` (cout,) or None; ``span_c`` channels per recombine
    group.  Returns (n, ho, wo, cout) f32.  ``pool=(2, 2)`` returns the
    VALID-maxpooled (n, ho//2, wo//2, cout) instead, bias added after the
    max; the conv height and width are ``out_hw`` (the kernel indexes
    pooled pixels, so rows past the conv map are never formed and need no
    mask).  CUDA tensors run the kernel, CPU tensors the plain version.
    """
    kw_ = dict(stride=stride, pads=pads, out_hw=out_hw, span_c=span_c,
               variant=variant, base_bits=base_bits, pool=pool)
    if not build.use_kernel(x):
        return conv2d_implicit_raw_plain(x, w_vals, ascale, wscale, bias,
                                         **kw_)
    _check(x, w_vals, ascale, wscale, bias, stride, out_hw, span_c, variant,
           base_bits)
    _check_pool(pool)
    dev = x.device
    n, h, w, cin = x.shape
    kh, kw, _, cout = w_vals.shape
    ho, wo = out_hw
    hp, wp = (ho // 2, wo // 2) if pool is not None else (ho, wo)
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    xc, asc, wsc, bs = f32(x), f32(ascale), f32(wscale), f32(bias)
    wv = w_vals.to(device=dev, dtype=torch.int16).contiguous()
    out = torch.empty((n, hp, wp, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    return _launch(
        (xc.data_ptr(), wv.data_ptr(), asc.data_ptr(), None, wsc.data_ptr(),
         build.ptr(bs), out.data_ptr(), n, h, w, cin, cout, kh, kw, stride,
         pads[0], pads[1], ho, wo, span_c, kom_qmax(base_bits), base_bits,
         int(variant == "karatsuba"), int(pool is not None), 0, hp, wp,
         build.stream_ptr(xc)),
        out, NAME if pool is None else POOL_NAME, cin=cin, cout=cout, kh=kh,
        kw=kw, span_c=span_c, karatsuba=variant == "karatsuba")


def conv2d_implicit_handoff_raw(q, grid, w_vals, wscale, bias=None, *,
                                bk: int, variant: str, base_bits: int,
                                pool=None) -> torch.Tensor:
    """The handoff consumer: a 3x3/s1/SAME conv over pre-quantized pixels.

    ``q`` (n, h+2, w+2, cin) int16 padded values and ``grid`` (n, th, tw)
    f32 power-of-two cell scales (a ``QActivation``); ``bk`` the Cin chunk
    whose per-tap recombines fix the f32 order.  Returns (n, h, w, cout)
    f32, or the (2, 2)-pooled map with ``pool``.  The kernel reads the cell
    scale of each tap from the small grid; the upsampled plane is never
    formed.  CUDA tensors run the kernel, CPU tensors the plain version.
    """
    kw_ = dict(bk=bk, variant=variant, base_bits=base_bits, pool=pool)
    if not build.use_kernel(q):
        return conv2d_implicit_handoff_plain(q, grid, w_vals, wscale, bias,
                                             **kw_)
    _check_handoff(q, grid, w_vals, wscale, bias, bk, variant, base_bits)
    _check_pool(pool)
    dev = q.device
    n, hpad, wpad, cin = q.shape
    cout = w_vals.shape[3]
    ho, wo = hpad - 2, wpad - 2
    hp, wp = (ho // 2, wo // 2) if pool is not None else (ho, wo)
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    gr, wsc, bs = f32(grid), f32(wscale), f32(bias)
    qv = q.to(device=dev, dtype=torch.int16).contiguous()
    wv = w_vals.to(device=dev, dtype=torch.int16).contiguous()
    out = torch.empty((n, hp, wp, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    return _launch(
        (qv.data_ptr(), wv.data_ptr(), None, gr.data_ptr(), wsc.data_ptr(),
         build.ptr(bs), out.data_ptr(), n, hpad, wpad, cin, cout, 3, 3, 1,
         0, 0, ho, wo, bk, kom_qmax(base_bits), base_bits,
         int(variant == "karatsuba"), int(pool is not None), 1, hp, wp,
         build.stream_ptr(qv)),
        out, HANDOFF_NAME, cin=cin, cout=cout, kh=3, kw=3, span_c=bk,
        karatsuba=variant == "karatsuba")


def _check_float(x, w, bias, stride, out_hw, variant):
    if variant not in FLOAT_PASSES:
        raise ValueError(f"float variants only, got {variant!r}")
    if x.shape[3] != w.shape[2]:
        raise ValueError(f"weight cin {w.shape[2]} != input cin {x.shape[3]}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError("bias must have shape (cout,)")
    if stride < 1 or min(out_hw) < 0:
        raise ValueError(f"bad stride {stride} or output {out_hw}")


def conv2d_implicit_float_plain(x, w, bias=None, *, stride: int, pads: tuple,
                                out_hw: tuple, variant: str) -> torch.Tensor:
    """The float variants' function in PyTorch, on any device.

    The reference's ``_stream_conv_float``: per-tap strided slices of the
    zero-padded input, one dot per tap -- native f32 products or the 3 or 6
    bf16 limb passes -- summed over the taps; here every sum is exact (f64,
    :func:`~repro_torch.core.karatsuba.schedule_dot`), rounded once to f32,
    then ``+ bias`` in f32 as the kernel's epilogue adds it.
    """
    _check_float(x, w, bias, stride, out_hw, variant)
    n, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    ho, wo = out_hw
    pad_t, pad_l = pads
    need_h, need_w = (ho - 1) * stride + kh, (wo - 1) * stride + kw
    xp = F.pad(x.to(torch.float32),
               (0, 0, pad_l, max(need_w - wd - pad_l, 0),
                pad_t, max(need_h - h - pad_t, 0)))
    out = None
    for dy in range(kh):
        for dx in range(kw):
            rows = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                      dx:dx + (wo - 1) * stride + 1:stride]
            d = schedule_dot(rows, w[dy, dx], passes=FLOAT_PASSES[variant])
            out = d if out is None else out + d
    out = out.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out


def conv2d_implicit_float_raw(x, w, bias=None, *, stride: int, pads: tuple,
                              out_hw: tuple, variant: str,
                              counter: str | None = None) -> torch.Tensor:
    """Float implicit-GEMM conv with the bias epilogue.

    ``x`` (n, h, w, cin) f32 UNPADDED NHWC (``pads`` = (top, left);
    bottom/right follow from ``out_hw``); ``w`` (kh, kw, cin, cout) f32;
    ``bias`` (cout,) or None; ``variant`` ``native``, ``bf16x3`` or
    ``bf16x6``.  Returns (n, ho, wo, cout) f32.  CUDA tensors run the
    kernel (each variant counts its own launches, under ``counter`` when
    given: the systolic engine's ``native`` calls), CPU tensors the plain
    version.
    """
    kw_ = dict(stride=stride, pads=pads, out_hw=out_hw, variant=variant)
    if not build.use_kernel(x):
        return conv2d_implicit_float_plain(x, w, bias, **kw_)
    _check_float(x, w, bias, stride, out_hw, variant)
    dev = x.device
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    xc, wc, bs = f32(x), f32(w), f32(bias)
    n, h, wd, cin = xc.shape
    kh, kw, _, cout = wc.shape
    ho, wo = out_hw
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    passes = FLOAT_PASSES[variant]
    lib = build.library(FLOAT_LIB, _FLOAT_ARGTYPES)
    # The bf16 limb planes and the tap groups' sums, as the kernel sizes them.
    nbytes = lib.implicit_conv_float_scratch(n, h, wd, cin, cout, kh, kw, ho,
                                             wo, passes)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=dev)
               if nbytes else None)
    code = lib.implicit_conv_float_launch(
        xc.data_ptr(), wc.data_ptr(), build.ptr(bs), out.data_ptr(),
        build.ptr(scratch), nbytes, n, h, wd, cin, cout, kh, kw, stride,
        pads[0], pads[1], ho, wo, passes, build.stream_ptr(xc))
    name = counter or FLOAT_NAMES[variant]
    build.check_launch(lib, code, name)
    build.LAUNCHES[name] += 1
    return out
