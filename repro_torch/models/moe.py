"""Top-k routed MoE FFN (the port of ``repro.models.moe``).

Tokens are routed in fixed-size groups with a capacity factor, the
dropping formulation of GShard/Switch: in each group every expert takes at
most ``cap`` (token, slot) assignments, the first ``cap`` in group order,
and a dropped assignment contributes nothing.

The reference dispatches and combines with one-hot einsums over a (group,
token, expert, capacity) tensor.  Every product there is by 0 or 1 (the
dispatch) or sums at most ``top_k`` non-zero terms (the combine), so the
port gets the same values from a scatter into the (group, expert,
capacity, d) buffer and a gather out of it, without the one-hot tensor
(~180 GFLOP per layer each way at olmoe-1b-7b's prefill).  The expert
products are batched matmuls over experts in the compute dtype, as the
reference's einsums are (no Pallas kernel computes them).

Routing (:func:`moe_route`), :func:`dispatch`, :func:`experts` and
:func:`combine` are module-level functions that :func:`moe_ffn` looks up
at call time, so that a caller can record or pin the routing, or time a
step, by replacing one of them.  Top-k breaks ties toward the lower expert
index, as ``lax.top_k`` does.  ``cfg.act_dp`` is data only: the port has
no mesh, so there is no expert-parallel constraint.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _randn, linear_init


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32):
    """The reference's tree and distributions: ``router`` f32 (d, e);
    ``wg``, ``wu`` (e, d, d_ff) N(0, 1/d); ``wd`` (e, d_ff, d) N(0, 1/d_ff)."""
    d, dff, e = cfg.d_model, cfg.d_ff, cfg.moe_num_experts
    s_in = 1.0 / (d ** 0.5)
    s_out = 1.0 / (dff ** 0.5)
    return {
        "router": linear_init(gen, d, e, torch.float32),
        "wg": (_randn(gen, (e, d, dff), dtype) * s_in).to(dtype),
        "wu": (_randn(gen, (e, d, dff), dtype) * s_in).to(dtype),
        "wd": (_randn(gen, (e, dff, d), dtype) * s_out).to(dtype),
    }


def moe_capacity(group_size: int, top_k: int, n_experts: int,
                 factor: float) -> int:
    c = int(group_size * top_k * factor / n_experts) + 1
    return max(4, -(-c // 4) * 4)  # multiple of 4, at least 4


def moe_route(params, xg: torch.Tensor, cfg):
    """Route one batch of groups ``xg`` (g, s, d).

    Returns ``(probs, gate, idx, pos, keep)``: the router's f32 softmax (g,
    s, e); the top-k gates renormalised in f32 and their experts (g, s, k),
    the larger probability first and ties to the lower index; each (token,
    slot)'s position in its expert's capacity buffer, an exclusive running
    count over the group's (token, slot) pairs in order (g, s, k); and
    ``keep = pos < cap``.
    """
    g, s, _ = xg.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = moe_capacity(s, k, e, cfg.moe_capacity_factor)
    logits = torch.matmul(xg.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :k], order[..., :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    # the exclusive count: a stable sort by expert keeps group order within
    # each expert, so a pair's rank in its expert's run is its position
    flat = idx.reshape(g, s * k)
    by_expert, perm = torch.sort(flat, dim=1, stable=True)
    counts = torch.zeros((g, e), dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    start = torch.cumsum(counts, dim=1) - counts          # (g, e)
    rank = torch.arange(s * k, device=flat.device) \
        - torch.gather(start, 1, by_expert)
    pos = torch.empty_like(flat).scatter_(1, perm, rank).reshape(g, s, k)
    return probs, gate, idx, pos, pos < cap


def _buffer_rows(idx, pos, cap: int) -> torch.Tensor:
    """Each (token, slot)'s row of the experts' buffer, laid out (expert,
    group, capacity slot): ``(idx * g + group) * cap + pos``, (g, s, k)."""
    g = idx.shape[0]
    group = torch.arange(g, device=idx.device).reshape(g, 1, 1)
    return (idx * g + group) * cap + pos


def dispatch(xg: torch.Tensor, idx, pos, keep, n_experts: int,
             cap: int) -> torch.Tensor:
    """The experts' inputs (e, g * cap, d): each kept (token, slot)'s
    token of ``xg`` (g, s, d) in its row (:func:`_buffer_rows`), empty
    rows zero -- one gather of token rows, through a map from each buffer
    row to its token that dropped pairs do not enter."""
    g, s, d = xg.shape
    k = idx.shape[-1]
    rows = n_experts * g * cap
    dst = torch.where(keep, _buffer_rows(idx, pos, cap), rows).reshape(-1)
    token = torch.arange(g * s, device=xg.device).repeat_interleave(k)
    src = torch.full((rows + 1,), g * s, dtype=token.dtype,
                     device=xg.device)
    src.scatter_(0, dst, token)            # the spare last entry is cut
    x = torch.cat([xg.reshape(g * s, d), xg.new_zeros((1, d))])
    return x[src[:rows]].reshape(n_experts, g * cap, d)


def experts(params, expert_in: torch.Tensor) -> torch.Tensor:
    """The three expert products, batched over experts, in the inputs'
    dtype: (e, rows, d) -> (e, rows, d); ``silu`` in f32, cast back
    before the product with the up projection."""
    dtype = expert_in.dtype
    hg = torch.bmm(expert_in, params["wg"].to(dtype))
    hu = torch.bmm(expert_in, params["wu"].to(dtype))
    h = F.silu(hg.to(torch.float32)).to(dtype) * hu
    return torch.bmm(h, params["wd"].to(dtype))


def combine(expert_out: torch.Tensor, gate, idx, pos, keep, cap: int
            ) -> torch.Tensor:
    """Each (token, slot)'s expert output (``expert_out`` (e, g * cap, d),
    rows as :func:`_buffer_rows`) times its gate, rounded to the compute
    dtype first as the reference rounds its combine tensor, summed over
    the k slots in f32 and rounded once: (g, s, d); a dropped slot adds
    nothing."""
    e, _, d = expert_out.shape
    g, s, k = idx.shape
    dtype = expert_out.dtype
    at = torch.where(keep, _buffer_rows(idx, pos, cap), 0).reshape(-1)
    out = expert_out.reshape(-1, d)[at].reshape(g * s, k, d)
    w = torch.where(keep, gate.to(dtype), 0).to(torch.float32)
    y = torch.bmm(w.reshape(g * s, 1, k), out.to(torch.float32))
    return y.reshape(g, s, d).to(dtype)


def moe_ffn(params, x: torch.Tensor, cfg):
    """x (b, s, d) -> (y (b, s, d) in x's dtype, f32 Switch aux loss).

    Routing, dispatch, the experts and the combine are module-level
    functions looked up at call time (see the module docstring)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    tokens = b * s
    gsz = min(cfg.moe_group_size, tokens)
    assert tokens % gsz == 0, (tokens, gsz)
    g = tokens // gsz
    cap = moe_capacity(gsz, k, e, cfg.moe_capacity_factor)
    xg = x.reshape(g, gsz, d)
    probs, gate, idx, pos, keep = moe_route(params, xg, cfg)
    expert_out = experts(params, dispatch(xg, idx, pos, keep, e, cap))
    y = combine(expert_out, gate, idx, pos, keep, cap)

    # Switch-style load-balance loss over all routed slots
    me = torch.mean(probs, dim=1)                             # (g, e)
    kept = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    kept.scatter_add_(1, idx.reshape(g, gsz * k),
                      keep.reshape(g, gsz * k).to(torch.float32))
    ce = kept / gsz                                           # (g, e)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1)) / k
    return y.reshape(b, s, d), aux
