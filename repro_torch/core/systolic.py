"""The materialized im2col-GEMM conv path and pooling (port of
``repro.core.systolic``'s ``conv2d_im2col`` and ``pool2d``).

Under the integer policies the patch GEMM runs on the limb GEMM kernel
through :func:`~repro_torch.core.substrate.prequant_dot_general`: per-row
(= per-patch) activation scales, or the shared per-tile scales on
Winograd-eligible layers (the VGG stem), and the bias in the kernel's
``fma(raw, t, b)`` epilogue.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import MatmulPolicy, policy_matmul
from .substrate import (QWeight, conv_pads, dequantize_weight, kom_qmax,
                        policy_int_spec, prequant_dot_general)


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           pads) -> torch.Tensor:
    """NHWC patches as rows: (n*ho*wo, cin*kh*kw) in (cin, kh, kw) order,
    the column order of ``lax.conv_general_dilated_patches``."""
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    patches = F.unfold(xp, kernel_size=(kh, kw), stride=stride)
    n, ck, _ = patches.shape
    return patches.transpose(1, 2).reshape(-1, ck)


def conv2d_im2col(x: torch.Tensor, w, *, stride: int = 1,
                  padding: str = "SAME",
                  policy: MatmulPolicy = MatmulPolicy.NATIVE_BF16,
                  bias: torch.Tensor | None = None,
                  activation: str | None = None) -> torch.Tensor:
    """NHWC conv as im2col-GEMM.  ``w``: HWIO float tensor or a QWeight."""
    from repro_torch.kernels.conv2d.winograd import (tile_scale_grid,
                                                     tile_scales_upsampled,
                                                     winograd_scale_eligible)

    kh, kw, cin, cout = w.shape
    n = x.shape[0]
    ho, wo, pads = conv_pads(x.shape[1], x.shape[2], kh, kw, stride, padding)
    x = x.to(torch.float32)
    cols = im2col(x, kh, kw, stride, pads)
    ck = cols.shape[1]
    spec = policy_int_spec(policy) if isinstance(w, QWeight) else None
    if spec is not None:
        wmat = QWeight(w.values.permute(2, 0, 1, 3).reshape(ck, cout),
                       w.scale, w.base_bits)
        row_scale = None
        if winograd_scale_eligible(kh, kw, stride, cin, variant=spec[0],
                                   base_bits=w.base_bits):
            (pt, pb), (pl, pr) = pads
            xp = F.pad(x, (0, 0, pl, pr, pt, pb))
            s_tile = tile_scale_grid(xp, kom_qmax(w.base_bits),
                                     -(-ho // 2), -(-wo // 2))
            row_scale = tile_scales_upsampled(s_tile, ho, wo).reshape(-1, 1)
        out = prequant_dot_general(cols, wmat, variant=spec[0],
                                   row_scale=row_scale, bias=bias)
    else:
        wf = dequantize_weight(w) if isinstance(w, QWeight) else w
        out = policy_matmul(cols, wf.permute(2, 0, 1, 3).reshape(ck, cout),
                            policy=policy)
        if bias is not None:
            out = out + bias
    out = out.reshape(n, ho, wo, cout)
    if activation == "relu":
        out = torch.relu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation: {activation!r}")
    return out


def pool2d(x: torch.Tensor, *, window: int, stride: int, kind: str = "max",
           padding: str = "VALID") -> torch.Tensor:
    """NHWC pooling (VALID windows)."""
    if padding != "VALID":
        raise NotImplementedError("pool2d: VALID pooling only in the port")
    xc = x.to(torch.float32).permute(0, 3, 1, 2)
    if kind == "max":
        out = F.max_pool2d(xc, window, stride)
    elif kind == "avg":
        out = F.avg_pool2d(xc, window, stride)
    else:
        raise ValueError(kind)
    return out.permute(0, 2, 3, 1).contiguous()
