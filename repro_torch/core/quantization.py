"""Symmetric quantization for the KOM integer path.

The quantization state and quantizers live in
:mod:`repro_torch.core.substrate`; this module re-exports them, as the
reference's ``repro.core.quantization`` does.  Its QTensor x QTensor
conveniences (``quantized_dot_general``, ``kom_linear``) serve the
straight-through training path, which is not ported yet.
"""
from __future__ import annotations

from .substrate import (  # noqa: F401
    QTensor,
    QWeight,
    dequantize_weight,
    kom_qmax,
    prequant_dot_general,
    quantize_symmetric,
    quantize_weight,
)
