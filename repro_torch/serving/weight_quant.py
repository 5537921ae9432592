"""Weight quantization for KOM serving (W14 static, A14 dynamic): the port
of ``repro.serving.weight_quant``'s :data:`QUANT_LEAVES` and
:func:`quantize_params_inline`.

Serving quantizes the matmul weights once, at engine build, into cached
:class:`~repro_torch.core.substrate.QWeight` leaves (int16 values,
per-output-channel scales); every decode step then quantizes activations
only.  The reference's legacy split view (``quantize_param_tree``) and
``kom_linear_prequant`` have no caller on the port's path yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.substrate import quantize_weight

#: 2-D matmul weights that are worth pre-quantizing (matches sharding names)
QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
                "w_x", "w_y", "w_a", "w_i", "w_out", "lm_head"}


def quantize_params_inline(params, *, base_bits: int = 7,
                           leaves=QUANT_LEAVES, in_place: bool = False):
    """One quantization pass: matmul leaves -> cached QWeight.

    The returned tree has the same structure as ``params``.  Matmul leaves
    are (..., k, n); any extra leading axes are layer or group stacks and
    survive in the scale (``stack_axes = ndim - 2``), so the QWeight still
    slices per layer.  In an xLSTM tree (``groups``/``b{i}``/``mixer``)
    that is ``w_up``, ``w_gate``, ``wq``, ``wk``, ``wv``, ``w_in`` and
    ``w_down``; ``w_if``, ``conv_w``, ``r``, ``b`` and the norms stay
    float (``w_if`` and a tied head then run ``kom_q_dot``).  Scales are
    the eager true division, as the reference quantizes outside ``jit``
    at engine build.

    ``in_place``: the returned tree IS ``params``, each matmul leaf
    replaced as its QWeight is made, so that the float leaf is freed then
    if nothing else holds it (a full-width internvl2-26b is 39.7 GB in
    bf16 and its QWeights 38.6 GB: the two trees do not fit one 80 GB
    card side by side).
    """
    def q(name, leaf):
        if isinstance(leaf, dict):
            return {k: q(k, v) for k, v in leaf.items()}
        if name in leaves and isinstance(leaf, torch.Tensor) \
                and leaf.ndim >= 2:
            return quantize_weight(leaf, base_bits=base_bits,
                                   stack_axes=leaf.ndim - 2)
        return leaf

    if not in_place:
        return {k: q(k, v) for k, v in params.items()}

    def replace(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                replace(v)
            else:
                tree[k] = q(k, v)
    replace(params)
    return params
