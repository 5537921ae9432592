"""Integer Winograd F(2x2, 3x3): bounds, scale plan, transforms, kernel.

The port of ``repro/kernels/conv2d/winograd.py``.  Its TPU kernel
``_winograd_kernel`` (``conv2d_winograd_raw``) becomes the CUDA kernel in
``repro_torch/csrc/winograd.cu``; :func:`conv2d_winograd_raw_plain` beside
the wrapper repeats its arithmetic in PyTorch.  The kernel runs the
pointwise contractions as int8 ``mma.sync`` on the tensor cores: every
transformed plane splits once more into two balanced int8 sub-digits of
base 2^:data:`WINOGRAD_SUB_BITS`, and each point's contraction over a chunk
of :data:`WINOGRAD_CHUNK` channels folds into the inverse transform in
int32; :func:`winograd_plan` splits the chunks over grid.z (the CPU tests
emulate that walk).

The transforms live in the quantized-limb INTEGER domain (every matrix has
entries in {-1, 0, 1, 2}), so

    AT [ (G2 g G2t) .*. (BT d B) ] A  ==  4 * correlate(d, g)      (exact)

and the 1/4 folds into the per-channel dequant scale (an exact exponent
shift).  Activations are quantized with ONE scale per 4x4 tile
(:func:`tile_scale_grid`), shared by every integer conv path on the layers
:func:`winograd_scale_eligible` admits, so all paths see the same integers.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.substrate import (F32_EXACT, activation_scale,
                                        balanced_split, dequant_epilogue,
                                        kom_qmax, limb_recombine,
                                        quantize_values)
from repro_torch.kernels import build

from .conv2d import grid_k_splits, int_accum_bound

BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
G2 = ((2, 0, 0), (1, 1, 1), (1, -1, 1), (0, 0, 2))
AT = ((1, 1, 1, 0), (0, 1, -1, -1))

#: Two G2 = 2*G factors: the integer engine computes 4x the convolution.
WINOGRAD_OUTPUT_SCALE = 4

_INT_VARIANTS = ("karatsuba", "schoolbook")

NAME = "winograd"
_ARGTYPES = {"winograd_launch": [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
             + [ctypes.c_int] * 16 + [ctypes.c_void_p],
             "winograd_scratch": ([ctypes.c_int] * 5, ctypes.c_longlong)}
#: The kernel's sub-digit base: X = 2^7 X1 + X0, balanced, both int8.
WINOGRAD_SUB_BITS = 7
#: Input channels of one chunk of the kernel's walk: one int8 MMA depth.
WINOGRAD_CHUNK = 32
#: Winograd tiles and output channels of one block of the kernel (its
#: BM, BN).
WINOGRAD_BLOCK = (16, 128)
#: The most K splits the plan takes.
WINOGRAD_MAX_SPLITS = 4


def winograd_plan(tiles: int, cin: int, cout: int, *, sms: int) -> dict:
    """The kernel's grid: blocks of :data:`WINOGRAD_BLOCK` (tiles flattened
    over the batch), and the chunks of :data:`WINOGRAD_CHUNK` channels split
    into ``splits`` runs of ``per_split`` over grid.z by
    :func:`~repro_torch.kernels.conv2d.conv2d.grid_k_splits`; the splits
    add their int32 inverse-transform sums as integers."""
    bm, bn = WINOGRAD_BLOCK
    blocks = -(-tiles // bm) * -(-cout // bn)
    chunks = -(-cin // WINOGRAD_CHUNK)
    splits = grid_k_splits(blocks, chunks, sms=sms,
                           max_splits=WINOGRAD_MAX_SPLITS)
    per_split = -(-chunks // splits)
    return {"chunks": chunks, "splits": -(-chunks // per_split),
            "per_split": per_split}


def winograd_accum_bound(cin: int, *, variant: str, base_bits: int) -> int:
    """Worst-case |int32| at any conversion point: 4x the direct bound."""
    return WINOGRAD_OUTPUT_SCALE * int_accum_bound(
        3, 3, cin, variant=variant, base_bits=base_bits)


def winograd_scale_eligible(kh: int, kw: int, stride: int, cin: int, *,
                            variant: str, base_bits: int) -> bool:
    """True iff the layer runs the SHARED tile-granular activation scales."""
    return (variant in _INT_VARIANTS and kh == 3 and kw == 3 and stride == 1
            and winograd_accum_bound(cin, variant=variant,
                                     base_bits=base_bits) < 2**31)


# ---------------------------------------------------------------------------
# Shared tile-granular activation scale plan.
# ---------------------------------------------------------------------------

def channel_absmax(x: torch.Tensor) -> torch.Tensor:
    """max over channels of |x|: (n, h, w, c) -> (n, h, w) f32."""
    return x.to(torch.float32).abs().amax(dim=3)


def tile_scales_from_cmax(cmax_p: torch.Tensor, qmax: int, th: int,
                          tw: int) -> torch.Tensor:
    """(n, th, tw) tile scales from the PADDED channel abs-max image.

    Tile (ty, tx) covers padded rows 2ty..2ty+3 and columns 2tx..2tx+3; the
    image is zero-padded out to the (2*th+2, 2*tw+2) footprint (zeros never
    raise a max).
    """
    ph = max(2 * th + 2 - cmax_p.shape[1], 0)
    pw = max(2 * tw + 2 - cmax_p.shape[2], 0)
    if ph or pw:
        cmax_p = F.pad(cmax_p, (0, pw, 0, ph))
    amax = F.max_pool2d(cmax_p[:, None], kernel_size=4, stride=2)[:, 0]
    return activation_scale(amax[:, :th, :tw], qmax)


def tile_scale_grid(xp: torch.Tensor, qmax: int, th: int,
                    tw: int) -> torch.Tensor:
    """Per-4x4-tile activation scales from the padded NHWC input."""
    return tile_scales_from_cmax(channel_absmax(xp), qmax, th, tw)


def tile_scales_upsampled(s: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    """Tile scales (n, th, tw) -> per-output-position scales (n, ho, wo)."""
    s = s.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return s[:, :ho, :wo]


# ---------------------------------------------------------------------------
# Integer transforms.
# ---------------------------------------------------------------------------

def _lincomb(coefs, arrs):
    acc = None
    for c, v in zip(coefs, arrs):
        if c == 0:
            continue
        t = v if c == 1 else (-v if c == -1 else v * c)
        acc = t if acc is None else acc + t
    return acc


def winograd_transform_2d(M, g: torch.Tensor) -> torch.Tensor:
    """M . g . Mt over the two leading point-grid axes of ``g`` (exact)."""
    p, q = len(M), len(M[0])
    left = [_lincomb(M[i], [g[a] for a in range(q)]) for i in range(p)]
    out = [[_lincomb(M[j], [left[i][b] for b in range(q)]) for j in range(p)]
           for i in range(p)]
    return torch.stack([torch.stack(r) for r in out])


def winograd_weight_planes(w_vals: torch.Tensor, base_bits: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """G2 . g_limb . G2t per balanced limb plane: 2 x (4, 4, cin, cout) int16.

    Split FIRST, transform each plane (|U| <= 9h): (uh, ul) are not balanced
    digits of U and both reach the contraction as they are.
    """
    wh, wl = balanced_split(w_vals, base_bits)
    return (winograd_transform_2d(G2, wh).to(torch.int16),
            winograd_transform_2d(G2, wl).to(torch.int16))


def winograd_input_planes(q4: torch.Tensor, base_bits: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """BT . d_limb . B per balanced limb plane of (4, 4, ...) tile ints."""
    dh, dl = balanced_split(q4, base_bits)
    return winograd_transform_2d(BT, dh), winograd_transform_2d(BT, dl)


def winograd_inverse(m_hh, m_mid, m_ll, *, base_bits: int) -> torch.Tensor:
    """At . m . A per int32 limb plane, then ONE f32 recombine: (2, 2, ...)."""
    return limb_recombine(winograd_transform_2d(AT, m_hh),
                          winograd_transform_2d(AT, m_mid),
                          winograd_transform_2d(AT, m_ll),
                          base_bits=base_bits)


#: |U| per Winograd point is w_u * w_v * h with G2 row weights (2, 3, 3, 2).
_G2_ROW_WEIGHT = (2, 3, 3, 2)


def _point_groups() -> list:
    groups: dict = {}
    for u in range(4):
        for v in range(4):
            groups.setdefault(_G2_ROW_WEIGHT[u] * _G2_ROW_WEIGHT[v],
                              []).append(4 * u + v)
    return sorted(groups.items())


def mirror_schedule(kdim: int, base_bits: int) -> list:
    """Per point group, the Cin chunks keeping every f32 partial < 2^24.

    |V| <= 4h everywhere and |U| <= w_u*w_v*h, so a group of weight w
    chunks at 2^24 // (4 w h^2), split into balanced chunks.
    """
    half = 1 << (base_bits - 1)
    plan = []
    for w, pts in _point_groups():
        safe_k = max(F32_EXACT // (4 * w * half * half), 1)
        n_chunks = -(-kdim // safe_k)
        size = -(-kdim // n_chunks)
        plan.append((pts, [(c0, min(c0 + size, kdim))
                           for c0 in range(0, kdim, size)]))
    return plan


def _pointwise_partials(vh, vl, uh, ul, *, base_bits):
    """The 16 pointwise contractions as exact chunked f32 batched GEMMs.

    ``vh``/``vl``: (16, m, cin) ints; ``uh``/``ul``: (16, cin, cout).  The
    mid partial uses the 4-product cross schedule, the same integer as the
    kernel's Karatsuba sum pass.  Returns three (16, m, cout) int32.
    """
    m, cout = vh.shape[1], uh.shape[2]
    shape = (16, m, cout)
    out = [torch.empty(shape, dtype=torch.int32, device=vh.device)
           for _ in range(3)]
    for pts, chunks in mirror_schedule(vh.shape[2], base_bits):
        idx = torch.tensor(pts, device=vh.device)
        a_h, a_l = vh[idx].to(torch.float32), vl[idx].to(torch.float32)
        b_h, b_l = uh[idx].to(torch.float32), ul[idx].to(torch.float32)
        dot = lambda a, b, c0, c1: torch.bmm(
            a[..., c0:c1], b[:, c0:c1]).to(torch.int32)
        hh = mid = ll = 0
        for c0, c1 in chunks:
            hh = hh + dot(a_h, b_h, c0, c1)
            ll = ll + dot(a_l, b_l, c0, c1)
            mid = mid + dot(a_h, b_l, c0, c1) + dot(a_l, b_h, c0, c1)
        for o, v in zip(out, (hh, mid, ll)):
            o[idx] = v
    return out


# ---------------------------------------------------------------------------
# The kernel wrapper and its plain version.
# ---------------------------------------------------------------------------

def _check(x, uh, ul, s_tile, wscale4, bias, out_hw, variant):
    if variant not in _INT_VARIANTS:
        raise ValueError(f"integer variants only, got {variant!r}")
    n, h, w, cin = x.shape
    if tuple(uh.shape[:3]) != (4, 4, cin) or uh.shape != ul.shape:
        raise ValueError(f"weight planes must be (4, 4, {cin}, cout), got "
                         f"{tuple(uh.shape)} / {tuple(ul.shape)}")
    cout = uh.shape[3]
    ho, wo = out_hw
    th, tw = -(-ho // 2), -(-wo // 2)
    if tuple(s_tile.shape) != (n, th, tw):
        raise ValueError(f"s_tile must be {(n, th, tw)}, got "
                         f"{tuple(s_tile.shape)}")
    if tuple(wscale4.shape) != (cout,) or (
            bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError("wscale4 and bias must have shape (cout,)")


def conv2d_winograd_raw_plain(x, uh, ul, s_tile, wscale4, bias=None, *,
                              pads: tuple, out_hw: tuple, variant: str,
                              base_bits: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, on any device."""
    _check(x, uh, ul, s_tile, wscale4, bias, out_hw, variant)
    n, h, w, cin = x.shape
    cout = uh.shape[3]
    ho, wo = out_hw
    th, tw = s_tile.shape[1], s_tile.shape[2]
    pad_t, pad_l = pads
    need_h, need_w = 2 * th + 2, 2 * tw + 2
    xp = F.pad(x.to(torch.float32),
               (0, 0, pad_l, max(need_w - w - pad_l, 0),
                pad_t, max(need_h - h - pad_t, 0)))
    # Point (u, v) of tile (ty, tx) is padded pixel (2ty + u, 2tx + v).
    x4 = torch.stack([torch.stack([
        xp[:, u:u + 2 * (th - 1) + 1:2, v:v + 2 * (tw - 1) + 1:2, :]
        for v in range(4)]) for u in range(4)])  # (4, 4, n, th, tw, cin)
    q4 = quantize_values(x4, s_tile.to(torch.float32)[..., None],
                         kom_qmax(base_bits))
    vh, vl = winograd_input_planes(q4, base_bits)
    m = n * th * tw
    parts = _pointwise_partials(
        vh.reshape(16, m, cin), vl.reshape(16, m, cin),
        uh.reshape(16, cin, cout), ul.reshape(16, cin, cout),
        base_bits=base_bits)
    m4 = [p.reshape(4, 4, n, th, tw, cout) for p in parts]
    raw4 = winograd_inverse(*m4, base_bits=base_bits)  # (2, 2, n, th, tw, co)
    raw = raw4.permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * th, 2 * tw, cout)
    raw = raw[:, :ho, :wo]
    t = tile_scales_upsampled(s_tile.to(torch.float32), ho, wo)[..., None] \
        * wscale4.to(torch.float32)
    return dequant_epilogue(raw, t, None if bias is None
                            else bias.to(torch.float32))


def conv2d_winograd_raw(x, uh, ul, s_tile, wscale4, bias=None, *,
                        pads: tuple, out_hw: tuple, variant: str,
                        base_bits: int) -> torch.Tensor:
    """Integer F(2x2, 3x3) conv with the fused dequant(+bias) epilogue.

    ``x`` (n, h, w, cin) f32 UNPADDED NHWC (``pads`` = (top, left)); ``uh``
    / ``ul`` (4, 4, cin, cout) int16 weight planes; ``s_tile`` (n, th, tw);
    ``wscale4`` (cout,) per-channel scales already times 1/4; ``bias``
    (cout,) or None.  Returns (n, ho, wo, cout) f32.  CUDA tensors run the
    kernel, CPU tensors :func:`conv2d_winograd_raw_plain`.
    """
    kw_ = dict(pads=pads, out_hw=out_hw, variant=variant,
               base_bits=base_bits)
    if not build.use_kernel(x):
        return conv2d_winograd_raw_plain(x, uh, ul, s_tile, wscale4, bias,
                                         **kw_)
    _check(x, uh, ul, s_tile, wscale4, bias, out_hw, variant)
    dev = x.device
    n, h, w, cin = x.shape
    cout = uh.shape[3]
    ho, wo = out_hw
    th, tw = s_tile.shape[1], s_tile.shape[2]
    f32 = lambda t: None if t is None else \
        t.to(device=dev, dtype=torch.float32).contiguous()
    xc, st, ws4, bs = f32(x), f32(s_tile), f32(wscale4), f32(bias)
    i16 = lambda t: t.to(device=dev, dtype=torch.int16).contiguous()
    uhc, ulc = i16(uh), i16(ul)
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.library(NAME, _ARGTYPES)
    karatsuba = int(variant == "karatsuba")
    plan = winograd_plan(n * th * tw, cin, cout, sms=build.num_sms(dev))
    nbytes = lib.winograd_scratch(cin, cout, karatsuba, n * th * tw,
                                  plan["splits"])
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    code = lib.winograd_launch(
        xc.data_ptr(), uhc.data_ptr(), ulc.data_ptr(), st.data_ptr(),
        ws4.data_ptr(), build.ptr(bs), out.data_ptr(), scratch.data_ptr(),
        nbytes, n, h, w, cin, cout, pads[0], pads[1], th, tw, ho, wo,
        kom_qmax(base_bits), base_bits, karatsuba, plan["splits"],
        plan["per_split"], build.stream_ptr(xc))
    build.check_launch(lib, code, NAME)
    build.LAUNCHES[NAME] += 1
    return out
