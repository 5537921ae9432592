"""The KOM multiplier substrate in PyTorch: one limb core for every consumer.

The port of ``repro.core.substrate``.  It keeps the reference's integers bit
for bit:

* **Limb splitting** (:func:`balanced_split`): the balanced base-2^b digit
  trick, defined once in the port.  Both digits of |x| <= kom_qmax(b) lie in
  [-2^(b-1), 2^(b-1)-1], so Karatsuba digit sums fit int8 with one guard bit.
* **Pass scheduling** (:func:`limb_partials` / :func:`limb_recombine` /
  :func:`limb_dot_general`): the 3-pass Karatsuba and 4-pass schoolbook
  schedules.  PyTorch has no integer GEMM on the GPU, so these plain
  versions run each pass as f32 GEMMs over K chunks whose worst-case partial
  sums stay below 2^24 (:func:`exact_int_matmul`) -- exact integers on any
  device, the strategy the reference's own lax mirrors use.
* **Quantization state** (:class:`QTensor`, :class:`QWeight`,
  :func:`quantize_symmetric`, :func:`quantize_weight`).
* **Conv dispatch** (:func:`select_conv_path`, :func:`conv2d`) and the
  pre-quantized handoff activation (:class:`QActivation`).

Rounding rules (pinned against ``jax.jit(cnn_forward)`` by the tests):

* activation scales are ``max(amax, 1e-12) * float32(1/qmax)``
  (:func:`activation_scale`): under ``jit`` XLA rewrites the reference's
  ``/ qmax`` into that multiply, and the serving forward is jitted;
* weight scales are a true division (``quantize_weight`` runs eagerly at
  engine build in the reference);
* quantization is a true division, then round half to even, then clip;
* dequant is ``raw * (s_act * s_w)``, and with a bias the reference's
  jitted forward contracts ``raw * t + b`` into ONE fused multiply-add on
  every layer (:func:`dequant_epilogue`).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple, Optional

import numpy as np
import torch

Variant = Literal["karatsuba", "schoolbook"]

#: Narrow passes per wide multiply (the paper's resource count).
PASS_COUNTS = {"karatsuba": 3, "schoolbook": 4}

#: Integer MatmulPolicy values -> (limb variant, base_bits).
INT_POLICY_SPECS = {
    "kom_int14": ("karatsuba", 7),
    "schoolbook_int16": ("schoolbook", 8),
}

#: Largest integer magnitude f32 holds exactly: the chunk budget of the
#: plain versions' f32-GEMM integer dots.
F32_EXACT = 1 << 24


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a stub of the port raises, naming its ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"{item})")


def policy_int_spec(policy) -> Optional[tuple[str, int]]:
    """(variant, base_bits) for integer-KOM policies, None for float ones."""
    return INT_POLICY_SPECS.get(getattr(policy, "value", policy))


def systolic_exact(policy) -> bool:
    """True iff the systolic conv engine implements ``policy`` exactly."""
    return (policy_int_spec(policy) is not None
            or getattr(policy, "value", policy) == "fp32")


#: Policies the implicit-GEMM conv engine implements exactly.
IMPLICIT_POLICIES = frozenset(
    {"kom_int14", "schoolbook_int16", "fp32", "bf16x3", "bf16x6"})


def implicit_supported(policy) -> bool:
    return getattr(policy, "value", policy) in IMPLICIT_POLICIES


def path_supports_policy(path: str, policy) -> bool:
    """THE path x policy capability table (same as the reference's)."""
    if path in ("auto", "im2col"):
        return True
    if path == "systolic":
        return systolic_exact(policy)
    if path == "implicit":
        return implicit_supported(policy)
    if path == "winograd":
        return policy_int_spec(policy) is not None
    raise ValueError(f"unknown conv path: {path!r}")


#: Epilogue fusion levels a plan entry may record.
FUSIONS = ("none", "bias_relu", "pool", "pool_quant")


def path_supports_fusion(path: str, fusion: str) -> bool:
    """THE path x fusion capability table (same as the reference's)."""
    if fusion not in FUSIONS:
        raise ValueError(f"unknown fusion: {fusion!r}")
    if path in ("auto", "im2col", "systolic", "winograd"):
        return fusion in ("none", "bias_relu")
    if path == "implicit":
        return True
    raise ValueError(f"unknown conv path: {path!r}")


def validate_path_policy(path: str, policy) -> None:
    """Raise ValueError when an EXPLICIT ``path`` cannot run ``policy``."""
    if path_supports_policy(path, policy):
        return
    pv = getattr(policy, "value", policy)
    implements = {
        "systolic": "the integer limb policies and fp32 only",
        "implicit": "the integer limb policies, fp32 and the bf16x3/bf16x6 "
                    "emulation schedules only",
        "winograd": "the integer limb policies only (the transforms live "
                    "in the quantized-limb domain)",
    }[path]
    raise ValueError(
        f"path={path!r} cannot run policy {pv!r} exactly: the {path} "
        f"engine implements {implements}, and an explicit path must not "
        "silently downgrade to native dots -- use path='auto' or "
        "path='im2col'")


# ---------------------------------------------------------------------------
# Limb decomposition.
# ---------------------------------------------------------------------------

def kom_qmax(base_bits: int = 7) -> int:
    """Largest |x| whose balanced (hi, lo) digits both fit [-2^(b-1), 2^(b-1)-1].

    kom_qmax(7) = 8127 ('int14'); kom_qmax(8) = 32639 ('int16').
    """
    half = 1 << (base_bits - 1)
    return (half - 1) * ((1 << base_bits) + 1)


def balanced_split(x: torch.Tensor, base_bits: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split int values into balanced base-2^b digits: x == hi*2^b + lo."""
    beta = 1 << base_bits
    half = beta >> 1
    x = x.to(torch.int32)
    lo = ((x + half) & (beta - 1)) - half
    hi = (x - lo) >> base_bits
    return hi, lo


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor,
                     term_bound: int) -> torch.Tensor:
    """Exact integer (..., k) x (k, n) -> int32, through f32 GEMMs.

    ``term_bound`` bounds |a_i * b_i| for one term.  K is cut into chunks of
    ``2^24 // term_bound`` terms, so every partial sum any GEMM order forms
    is an integer below 2^24 -- exact in f32 -- and the chunk results add up
    exactly in int32.  On the GPU this needs full-f32 GEMMs (no TF32).
    """
    if a.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "exact_int_matmul needs full-f32 GEMMs: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and float32 "
            "matmul precision 'highest'")
    k = a.shape[-1]
    step = max(F32_EXACT // term_bound, 1)
    af, bf = a.to(torch.float32), b.to(torch.float32)
    out = None
    for c0 in range(0, k, step):
        p = torch.matmul(af[..., c0:c0 + step], bf[c0:c0 + step]
                         ).to(torch.int32)
        out = p if out is None else out + p
    if out is None:
        out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.int32,
                          device=a.device)
    return out


def limb_partials_presplit(ah, al, bh, bl, *, variant: Variant = "karatsuba",
                           a_bound: int, b_bound: int):
    """The narrow passes over already-split planes: (p_hh, p_mid, p_ll).

    ``a_bound``/``b_bound`` bound |entries| of the planes (h = 2^(b-1) for
    fresh balanced digits; larger for transformed Winograd planes).
    Karatsuba forms p_mid = (Ah+Al)(Bh+Bl) - p_hh - p_ll, schoolbook
    Ah*Bl + Al*Bh: the same integer either way.
    """
    if variant not in PASS_COUNTS:
        raise ValueError(f"unknown variant: {variant}")
    tb = a_bound * b_bound
    p_hh = exact_int_matmul(ah, bh, tb)
    p_ll = exact_int_matmul(al, bl, tb)
    if variant == "karatsuba":
        p_mid = exact_int_matmul(ah + al, bh + bl, 4 * tb) - p_hh - p_ll
    else:
        p_mid = exact_int_matmul(ah, bl, tb) + exact_int_matmul(al, bh, tb)
    return p_hh, p_mid, p_ll


def limb_partials(a: torch.Tensor, b: torch.Tensor, *,
                  variant: Variant = "karatsuba", base_bits: int = 7):
    """The narrow passes of one wide (..., k) x (k, n) integer product."""
    if variant not in PASS_COUNTS:
        raise ValueError(f"unknown variant: {variant}")
    if variant == "karatsuba" and base_bits > 7:
        raise ValueError(
            "karatsuba digit sums need a guard bit: base_bits <= 7 for int8 "
            "passes")
    ah, al = balanced_split(a, base_bits)
    bh, bl = balanced_split(b, base_bits)
    half = 1 << (base_bits - 1)
    return limb_partials_presplit(ah, al, bh, bl, variant=variant,
                                  a_bound=half, b_bound=half)


def limb_recombine(p_hh, p_mid, p_ll, *, base_bits: int,
                   dtype=torch.float32) -> torch.Tensor:
    """(p_hh*beta^2 + p_mid*beta) + p_ll in ``dtype`` (int64 for bit-exact).

    The reference's evaluation order; each f32 operation rounds on its own.
    """
    beta = 1 << base_bits
    return (p_hh.to(dtype) * (beta * beta) + p_mid.to(dtype) * beta
            + p_ll.to(dtype))


def limb_dot_general(a: torch.Tensor, b: torch.Tensor, *,
                     variant: Variant = "karatsuba", base_bits: int = 7,
                     recombine_dtype=torch.float32) -> torch.Tensor:
    """Wide integer (..., k) x (k, n) out of narrow passes, one recombine."""
    p_hh, p_mid, p_ll = limb_partials(a, b, variant=variant,
                                      base_bits=base_bits)
    return limb_recombine(p_hh, p_mid, p_ll, base_bits=base_bits,
                          dtype=recombine_dtype)


# ---------------------------------------------------------------------------
# Quantization state.
# ---------------------------------------------------------------------------

def inv_qmax(qmax: int) -> np.float32:
    """float32(1/qmax), rounded once from the exact quotient."""
    return np.float32(1.0) / np.float32(qmax)


def activation_scale(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``max(amax, 1e-12) * float32(1/qmax)``: every activation scale."""
    return torch.clamp_min(amax.to(torch.float32), 1e-12) * float(inv_qmax(qmax))


def quantize_values(x: torch.Tensor, scale: torch.Tensor,
                    qmax: int) -> torch.Tensor:
    """clip(round_half_even(x / scale), -qmax, qmax) as int32.

    ``scale`` must be a tensor (never a Python scalar) so the division is a
    true IEEE division on every device.
    """
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int32)


class QTensor(NamedTuple):
    """Integer values + the float scale that dequantizes them (dynamic)."""

    values: torch.Tensor  # int32 holding |v| <= qmax
    scale: torch.Tensor   # f32, broadcastable against values
    qmax: int

    @property
    def shape(self):
        return self.values.shape


def quantize_symmetric(x: torch.Tensor, *, qmax: int | None = None,
                       base_bits: int = 7, axis=None) -> QTensor:
    """Symmetric quantization with the jitted reference's activation scale.

    ``axis``: None -> one scale for the tensor; an int or tuple -> per-slice
    scales along those KEPT axes, kept broadcastable.
    """
    if qmax is None:
        qmax = kom_qmax(base_bits)
    x = x.to(torch.float32)
    if axis is None:
        amax = x.abs().amax().reshape((1,) * max(x.ndim, 1))
    else:
        keep = (axis,) if isinstance(axis, int) else tuple(axis)
        keep = tuple(a % x.ndim for a in keep)
        red = tuple(i for i in range(x.ndim) if i not in keep)
        amax = x.abs().amax(dim=red, keepdim=True) if red else x.abs()
    scale = activation_scale(amax, qmax)
    return QTensor(values=quantize_values(x, scale, qmax), scale=scale,
                   qmax=qmax)


@dataclasses.dataclass(frozen=True, eq=False)
class QWeight:
    """A weight quantized ONCE at model build: int16 values + cached scales.

    ``values`` holds |v| <= kom_qmax(base_bits) with the output-channel axis
    LAST (FC (k, n), conv HWIO); ``scale`` is the per-output-channel f32
    scale, shape (cout,).  ``derived`` memoizes operands computed from the
    values once (the Winograd weight planes), so they die with the weight.
    """

    values: torch.Tensor
    scale: torch.Tensor
    base_bits: int = 7
    derived: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self):
        return tuple(self.values.shape)

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def device(self):
        return self.values.device

    def to(self, device) -> "QWeight":
        return QWeight(self.values.to(device), self.scale.to(device),
                       self.base_bits)

    def __getitem__(self, i) -> "QWeight":
        """Layer ``i`` of a stacked weight (values (L, k, n), scales
        (L, 1, n)): the slice ``lax.scan`` hands each layer in the
        reference."""
        return QWeight(self.values[i], self.scale[i], self.base_bits)


def quantize_weight(w: torch.Tensor, *, base_bits: int = 7,
                    stack_axes: int = 0) -> QWeight:
    """Per-output-channel (last axis) symmetric quantization, done once.

    ``stack_axes``: leading axes that are layer stacks rather than
    contraction dims (stacked transformer weights (L, k, n) use 1); the
    scales then keep them, shape (L, 1, n), so the QWeight slices per layer.
    The scale is a TRUE division ``max(amax, 1e-12) / qmax``: the reference
    quantizes weights eagerly at engine build, outside any ``jit``.
    """
    qmax = kom_qmax(base_bits)
    w = w.to(torch.float32)
    red = tuple(range(stack_axes, w.ndim - 1))
    if not red:
        amax = w.abs()
    else:
        amax = w.abs().amax(dim=red, keepdim=stack_axes > 0)
    amax = torch.clamp_min(amax, 1e-12)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int16)
    return QWeight(values=q, scale=scale, base_bits=base_bits)


def dequantize_weight(w: QWeight) -> torch.Tensor:
    return w.values.to(torch.float32) * w.scale


@dataclasses.dataclass(frozen=True)
class QActivation:
    """A pre-quantized activation handed between fused conv layers.

    Produced by the ``pool_quant`` epilogue fusion: the conv that FEEDS a
    3x3/s1/SAME integer layer quantizes its pooled output once per pixel
    with the consumer's tile-granular scale plan, so the consumer reads
    int16 values and a small scale grid instead of f32.

    ``values`` is the consumer's PADDED input, (n, h+2, w+2, c) int16,
    where pixel (py, px) used the 4x4/s2 cell scale
    ``scale[n, min(py//2, th-1), min(px//2, tw-1)]``; ``scale`` is that
    (n, th, tw) f32 grid of powers of two, th = ceil(h/2), tw = ceil(w/2).
    ``h``/``w`` are the true unpadded spatial dims, so :attr:`shape` is
    the logical (n, h, w, c) and plan lookups see the logical activation.
    Padding pixels quantize to exactly 0.
    """

    values: torch.Tensor
    scale: torch.Tensor
    base_bits: int = 7
    h: int = 0
    w: int = 0

    @property
    def shape(self):
        return (self.values.shape[0], self.h, self.w, self.values.shape[3])


def dequant_epilogue(raw: torch.Tensor, t: torch.Tensor | None,
                     bias: torch.Tensor | None) -> torch.Tensor:
    """The plain versions' dequant epilogue: ``raw*t`` or ``fma(raw, t, b)``.

    The reference's jitted forward computes ``raw * t + b`` as ONE fused
    multiply-add (XLA:CPU contracts it inside the fused epilogue).  In f64,
    ``raw * t`` is exact (24 + 24 bits) and the sum rounds twice, which
    equals the single-rounding FMA except in vanishingly rare double-rounding
    ties; the CUDA kernels use ``__fmaf_rn``.
    """
    if t is None:
        if bias is not None:
            raise ValueError("a bias needs dequant scales")
        return raw
    if bias is None:
        return raw * t
    return (raw.to(torch.float64) * t.to(torch.float64)
            + bias.to(torch.float64)).to(torch.float32)


class _InferenceOnly(torch.autograd.Function):
    """Identity whose backward raises: quantized round/clip would otherwise
    yield silent zero gradients for the whole upstream network."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "prequant_dot_general (cached QWeight path) is inference-only; "
            "train on the float params and quantize at deployment")


def prequant_dot_general(x: torch.Tensor, w: QWeight, *,
                         variant: Variant = "karatsuba",
                         row_scale: torch.Tensor | None = None,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Dynamic per-row activation quant x cached per-channel weight.

    ``x`` is (..., k) and ``w`` a (k, n) :class:`QWeight`; every activation
    row gets its own scale, so a request's outputs do not depend on its
    batch-mates.  ``row_scale`` (broadcastable against x, e.g. (m, 1))
    replaces the per-row scales, as the Winograd-shared tile scales do.
    ``bias`` (n,) rides the epilogue as ``fma(raw, s_row*s_col, b)``.
    The product runs on the limb GEMM kernel (plain version on the CPU).

    INFERENCE-ONLY: raises on backward.
    """
    from repro_torch.kernels.kom_matmul import kom_matmul_int

    if x.requires_grad and torch.is_grad_enabled():
        x = _InferenceOnly.apply(x)
    qmax = kom_qmax(w.base_bits)
    x = x.to(torch.float32)
    if row_scale is None:
        row_scale = activation_scale(x.abs().amax(dim=-1, keepdim=True), qmax)
    q = quantize_values(x, row_scale, qmax)
    lead, k = q.shape[:-1], q.shape[-1]
    rs = torch.broadcast_to(row_scale, lead + (1,)).reshape(-1)
    out = kom_matmul_int(q.reshape(-1, k).to(torch.int16), w.values,
                         variant=variant, base_bits=w.base_bits,
                         row_scale=rs.contiguous(),
                         col_scale=w.scale.reshape(-1),
                         bias=bias)
    return out.reshape(lead + (w.shape[-1],))


# ---------------------------------------------------------------------------
# Conv planning + dispatch.
# ---------------------------------------------------------------------------

def conv_pads(h, w, kh, kw, stride, padding):
    """SAME/VALID output sizes + explicit pads: (ho, wo, ((t, b), (l, r)))."""
    if padding == "SAME":
        ho = -(-h // stride)
        wo = -(-w // stride)
        pad_h = max((ho - 1) * stride + kh - h, 0)
        pad_w = max((wo - 1) * stride + kw - w, 0)
        pads = ((pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2))
    elif padding == "VALID":
        ho = (h - kh) // stride + 1
        wo = (w - kw) // stride + 1
        pads = ((0, 0), (0, 0))
    else:
        raise ValueError(padding)
    return ho, wo, pads


#: The thin-stem threshold: a conv with fewer input channels keeps the small
#: materialized patch GEMM (its per-tap contraction starves any streaming
#: engine).  A constant in the port until its tuner measures the crossover.
STEM_CIN = 16


def select_conv_path(*, kh: int, kw: int, stride: int, cin: int, cout: int,
                     policy=None, cached_weight: bool = False,
                     padding: str = "SAME") -> str:
    """Shape- and policy-driven conv dispatch (the reference's rule, GPU).

    Integer policies with a cached :class:`QWeight`: 3x3/s1/SAME layers
    under ``winograd_accum_bound`` -> ``winograd``; other layers with
    ``cin >= STEM_CIN`` -> ``implicit``; thin stems -> ``im2col``.  Float
    policies -> ``im2col``.  The reference selects the systolic engine and
    the implicit float variants only on the TPU, so this rule never picks
    them; they run when a caller pins ``path`` (their ranking on the card
    is the measured explorer's work).
    """
    del cout
    pv = getattr(policy, "value", policy)
    if pv in INT_POLICY_SPECS and cached_weight:
        if kh == 3 and kw == 3 and stride == 1 and padding == "SAME" \
                and cin >= STEM_CIN:
            from repro_torch.kernels.conv2d.winograd import \
                winograd_accum_bound
            variant, base_bits = INT_POLICY_SPECS[pv]
            if winograd_accum_bound(cin, variant=variant,
                                    base_bits=base_bits) < 2**31:
                return "winograd"
        return "implicit" if cin >= STEM_CIN else "im2col"
    return "im2col"


def conv2d(x, w, *, stride: int = 1, padding: str = "SAME",
           policy="native_bf16", path: str = "auto", block=None,
           bias: torch.Tensor | None = None,
           activation: Optional[str] = None, pool: tuple | None = None,
           quantize_next: int | None = None):
    """NHWC conv behind one policy-driven entry point, epilogue fused.

    ``w`` is an HWIO float tensor or a cached :class:`QWeight`.  ``path``:
    ``"auto"`` (the planner's heuristic), ``"im2col"``, ``"systolic"``,
    ``"implicit"`` or ``"winograd"``; an explicit engine that cannot run
    ``policy`` exactly raises (:func:`validate_path_policy`).  The systolic
    engine runs the integer policies and fp32 (a cached QWeight is
    dequantized under fp32), the implicit engine also bf16x3/bf16x6.
    ``block`` is the engine's tile schedule from a plan; the port's kernels
    pick their own tiles and read only the implicit engine's Cin chunk (it
    sets the recombine groups and the handoff consumer's f32 order).

    The implicit engine's epilogue fusions: ``pool=(window, pstride[,
    ppad])`` folds the FOLLOWING maxpool into the conv (the output is the
    pooled tensor); ``quantize_next=b`` hands the pooled output to the
    next 3x3/s1/SAME integer layer as a :class:`QActivation`.  A
    QActivation ``x`` is the consumer side and runs on the implicit engine
    only.  Any other engine raises on either.
    """
    from repro_torch.kernels.conv2d import (conv2d_implicit, conv2d_systolic,
                                            conv2d_winograd)

    from .systolic import conv2d_im2col

    kh, kw, cin, cout = w.shape
    if isinstance(x, QActivation):
        if path not in ("auto", "implicit"):
            raise ValueError(
                f"path={path!r} cannot consume a QActivation: pre-quantized "
                "handoff activations are an implicit-engine contract")
        path = "implicit"
    if path == "auto":
        from .planner import heuristic_path
        path = heuristic_path(kh=kh, kw=kw, stride=stride, cin=cin,
                              cout=cout, policy=policy, padding=padding,
                              cached_weight=isinstance(w, QWeight))
    if pool is not None or quantize_next is not None:
        want = "pool_quant" if quantize_next is not None else "pool"
        if not path_supports_fusion(path, want):
            raise ValueError(
                f"path={path!r} does not implement the {want!r} epilogue "
                "fusion; only the implicit engine pools/quantizes in its "
                "epilogue")
    if path == "im2col":
        return conv2d_im2col(x, w, stride=stride, padding=padding,
                             policy=policy, bias=bias, activation=activation)
    validate_path_policy(path, policy)
    spec = policy_int_spec(policy)
    if path == "systolic":
        if spec is None:
            variant, base_bits = "native", 7
            if isinstance(w, QWeight):
                w = dequantize_weight(w)
        else:
            variant, base_bits = spec
        return conv2d_systolic(x, w, stride=stride, padding=padding,
                               variant=variant, base_bits=base_bits,
                               bias=bias, activation=activation)
    if path == "implicit":
        if spec is None:
            pv = getattr(policy, "value", policy)
            variant, base_bits = ("native" if pv == "fp32" else pv), 7
        else:
            variant, base_bits = spec
        return conv2d_implicit(x, w, stride=stride, padding=padding,
                               block=block, variant=variant,
                               base_bits=base_bits, bias=bias,
                               activation=activation, pool=pool,
                               quantize_next=quantize_next)
    if path == "winograd":
        variant, base_bits = spec
        return conv2d_winograd(x, w, stride=stride, padding=padding,
                               variant=variant, base_bits=base_bits,
                               bias=bias, activation=activation)
    raise ValueError(f"unknown conv path: {path!r}")
