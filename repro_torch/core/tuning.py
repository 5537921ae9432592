"""Device-memory traffic model of one conv call on the port's kernels.

The port of ``repro.core.tuning.conv_hbm_bytes`` with its ``fusion`` and
``handoff_in`` axes, re-derived for the port's own tiles and dataflow (the
TPU's VMEM model and tile defaults do not apply).  Each engine is a tiled
GEMM that re-reads its A source once per Cout tile and its weights once
per M tile, with no credit for the 50 MB L2 -- a model for ranking
engines, not a measurement:

* ``implicit`` (``csrc/implicit_conv.cu``): 64 output pixels x 64 output
  channels per block, one image per block; with a pooled epilogue a block
  covers 16 pooled pixels (64 conv pixels).  A source: the compact NHWC
  input (f32, or the handoff's padded int16 plus its cell-scale grid) and
  the per-patch scales.
* ``systolic`` (``csrc/systolic_conv.cu``): the implicit kernel's tiles.
  Under the integer variants the input is quantized per sample first (an
  abs-max read and a quantize read of the f32 input, an int16 write), and
  the kernel re-reads the int16 map per Cout tile; ``native`` re-reads the
  f32 input.  The (n, cout) scale product rides along.
* ``winograd`` (``csrc/winograd.cu``): 32 tiles (flattened over the batch)
  x 64 output channels per block; the A source is the NHWC input plus the
  tile scales, the weights are the two int16 transformed planes (16
  points).
* ``im2col``: ``F.unfold`` writes the f32 patch matrix, the quantizer reads
  it and writes int16, and the limb GEMM (64 x 64 tiles) re-reads that per
  Cout tile.

The float variants (``native``, ``bf16x3``, ``bf16x6``) read f32 inputs and
f32 weights and have no activation scales.

Outputs and the PyTorch passes after the kernel: the kernel writes its f32
output (the pooled map under ``pool``/``pool_quant``); ReLU is one
in-place pass over it (read + write); ``"none"`` adds a separate bias pass;
``pool_quant`` adds ``handoff_quantize`` (read the pooled f32, write the
padded int16 values and the cell grid).  ``handoff_in`` prices the
consumer's A side as int16 + grid and drops its per-patch scales.
"""
from __future__ import annotations

#: The kernels' own tiles.
IMPLICIT_TILE = (64, 64)          # output pixels, output channels
SYSTOLIC_TILE = (64, 64)          # output pixels, output channels
IMPLICIT_POOLED_PIXELS = 16       # pooled pixels per implicit block
WINOGRAD_TILE = (32, 64)          # Winograd tiles, output channels
GEMM_TILE = (64, 64)              # limb GEMM rows, columns

_INT_VARIANTS = ("karatsuba", "schoolbook")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_hbm_bytes(path: str, *, kh, kw, stride, h, cin, cout, variant,
                   n: int = 1, fusion: str = "bias_relu",
                   handoff_in: bool = False) -> int:
    """Modeled device-memory bytes of one conv call (batch ``n``, SAME)."""
    integer = variant in _INT_VARIANTS
    ho = wo = _cdiv(h, stride)
    m = n * ho * wo
    kdim = kh * kw * cin
    if handoff_in:
        x_bytes = n * (h + 2) * (h + 2) * cin * 2 + n * _cdiv(h, 2) ** 2 * 4
    else:
        x_bytes = n * h * h * cin * 4
    hp, wp = max(ho // 2, 1), max(wo // 2, 1)     # 2x2/s2 VALID pool
    if fusion in ("pool", "pool_quant"):
        out_bytes = n * hp * wp * cout * 4
    elif fusion in ("bias_relu", "none"):
        out_bytes = m * cout * 4
    else:
        raise ValueError(f"unknown fusion {fusion!r}")
    passes = 2 * out_bytes                        # in-place ReLU
    if fusion == "none":
        passes += 2 * out_bytes                   # separate bias add
    if fusion == "pool_quant":
        passes += (out_bytes + n * (hp + 2) * (wp + 2) * cout * 2
                   + n * _cdiv(hp, 2) * _cdiv(wp, 2) * 4)
    w_elt = 2 if integer else 4
    w_bytes = kdim * cout * w_elt
    tail = out_bytes + passes
    if path == "im2col":
        patches = m * kdim
        cout_tiles = _cdiv(cout, GEMM_TILE[1])
        m_tiles = _cdiv(m, GEMM_TILE[0])
        return (x_bytes + 2 * 4 * patches            # unfold write, read
                + 2 * patches * (1 + cout_tiles)     # int16 write, re-reads
                + w_bytes * m_tiles + tail)
    if path == "implicit":
        cout_tiles = _cdiv(cout, IMPLICIT_TILE[1])
        if fusion in ("pool", "pool_quant"):
            m_tiles = n * _cdiv(hp * wp, IMPLICIT_POOLED_PIXELS)
        else:
            m_tiles = n * _cdiv(ho * wo, IMPLICIT_TILE[0])
        scales = m * 4 if integer and not handoff_in else 0
        return ((x_bytes + scales) * cout_tiles + w_bytes * m_tiles + tail)
    if path == "systolic":
        if fusion not in ("none", "bias_relu") or handoff_in:
            raise ValueError("the systolic engine fuses bias and ReLU only")
        cout_tiles = _cdiv(cout, SYSTOLIC_TILE[1])
        m_tiles = n * _cdiv(ho * wo, SYSTOLIC_TILE[0])
        if not integer:
            return x_bytes * cout_tiles + w_bytes * m_tiles + tail
        x16 = n * h * h * cin * 2
        return (2 * x_bytes + x16 + x16 * cout_tiles + w_bytes * m_tiles
                + n * cout * 4 + tail)
    if path == "winograd":
        th, tw = _cdiv(ho, 2), _cdiv(wo, 2)
        cout_tiles = _cdiv(cout, WINOGRAD_TILE[1])
        m_tiles = _cdiv(n * th * tw, WINOGRAD_TILE[0])
        planes = 2 * 16 * cin * cout * 2
        scales = n * th * tw * 4
        return ((x_bytes + scales) * cout_tiles + planes * m_tiles
                + cout * 4 + tail)
    raise ValueError(f"unknown path {path!r}")
