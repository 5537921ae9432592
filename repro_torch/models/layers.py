"""Shared layer primitives for the transformer zoo (the port of
``repro.models.layers``).

Every matmul routes through :func:`repro_torch.core.precision.policy_linear`,
so the KOM technique is a config switch for every architecture.  Weight
leaves may be float tensors or cached
:class:`~repro_torch.core.substrate.QWeight` (quantized once at engine
build); the policy layer handles both.  Params are plain dicts of tensors;
initializers draw from an explicit ``torch.Generator`` on its own device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.precision import MatmulPolicy, policy_linear
from repro_torch.core.substrate import policy_int_spec


def _randn(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def linear_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32):
    """N(0, 1/d_in) weights (d_in, d_out), as the reference draws them."""
    return (_randn(gen, (d_in, d_out), dtype) * (1.0 / d_in ** 0.5)).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype=torch.float32):
    return (_randn(gen, (vocab, d), dtype) * 0.02).to(dtype)


def dense(x: torch.Tensor, w, *, policy=MatmulPolicy.NATIVE_BF16,
          bias=None) -> torch.Tensor:
    """``policy_linear(x, w) + bias`` cast back to ``x``'s dtype.

    Under the integer policies the bias rides the limb GEMM's epilogue as
    one fused multiply-add (the reference's jitted ``raw * t + b``); under
    the float policies it is added to the product as it comes out (a bf16
    product plus an f32 bias promotes to f32, in both frameworks), then
    the sum is cast.
    """
    if policy_int_spec(policy) is not None:
        y = policy_linear(x, w, policy=policy, bias=bias)
    else:
        y = policy_linear(x, w, policy=policy)
        if bias is not None:
            y = y + bias
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps=1e-6) -> torch.Tensor:
    """RMS norm scaled by ``(1 + w)``, computed in f32."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + w.to(torch.float32))).to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def apply_norm(x, p, kind="rms"):
    if kind == "rms":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


def norm_init(d, kind="rms", dtype=torch.float32, device=None):
    if kind == "rms":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def rope(x: torch.Tensor, positions, *, theta=10000.0) -> torch.Tensor:
    """Rotary embedding; x (..., s, h, d) with positions (..., s) or (s,)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=x.device), ar / half)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    angles = (pos[..., :, None] * freqs)[..., :, None, :]  # (..., s, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, *, policy=MatmulPolicy.NATIVE_BF16):
    g = dense(x, w_gate, policy=policy)
    u = dense(x, w_up, policy=policy)
    return dense(F.silu(g.to(torch.float32)).to(x.dtype) * u, w_down,
                 policy=policy)


def gelu_mlp(x, w_up, b_up, w_down, b_down, *,
             policy=MatmulPolicy.NATIVE_BF16):
    h = dense(x, w_up, policy=policy, bias=b_up)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(h, w_down, policy=policy, bias=b_down)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv over time: x (b, s, d), w (k, d).

    Prefill (``state=None``): left-pad k-1 zeros.  Decode: ``state`` is the
    last k-1 inputs (b, k-1, d), prepended.  The taps are summed in tap
    order; returns (y in x's dtype, the new state = the last k-1 inputs).
    """
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else x[:, :0]
    return y.to(x.dtype), new_state
