"""Model assembly for the transformer zoo, dense family (the port of
``repro.models.transformer``).

Params keep the reference's pytree layout: a dict whose ``"layers"`` leaves
are STACKED (leading layer axis L), so a test can carry params across as
they are.  Where the reference scans the stack with ``lax.scan``, the port
loops over layers in Python (:func:`layer_params` slices one layer).

Public API (same names as the reference):
  init_params(cfg, generator)      -> params dict
  forward(params, cfg, batch)      -> (logits, aux)      [prefill]
  init_cache(cfg, batch, max_len)  -> decode cache dict
  serve_step(params, cfg, cache, tokens, pos, write_mask) -> (logits, cache)

Only ``family="dense"`` runs so far; MoE, VLM, encoder-decoder, hybrid and
SSM raise ``not_ported`` (ROADMAP.md, Queue 1 item 9), and ``loss_fn``
waits for the training slice.  Entry points run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.substrate import QWeight, not_ported
from repro_torch.device import resolve_device

from .attention import KVCache, attention, attn_init
from .config import ModelConfig
from .layers import (apply_norm, dense, embed_init, gelu_mlp, linear_init,
                     norm_init, rms_norm, rope, swiglu)

#: The ROADMAP.md item each family that is not ported yet waits for.
_FAMILY_ITEM = {
    "moe": "Queue 1 item 9: the MoE family (models/moe.py)",
    "vlm": "Queue 1 item 9: the VLM family",
    "encdec": "Queue 1 item 9: the encoder-decoder family",
    "hybrid": "Queue 1 item 9: the hybrid family (models/ssm.py)",
    "ssm": "Queue 1 item 9: the xLSTM/SSM family and _mlstm_kernel",
}


def _require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family == "dense":
        return
    if cfg.family in _FAMILY_ITEM:
        raise not_ported(f"{what} for family {cfg.family!r}",
                         _FAMILY_ITEM[cfg.family])
    raise ValueError(cfg.family)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked param tree (tensors and QWeights)."""
    return _map_tree(lambda t: t[i], stacked)


def params_to(params, device):
    """Every tensor / QWeight of a param tree moved to ``device``."""
    return _map_tree(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked_init(fn, n: int, device):
    """``fn()`` drawn ``n`` times, stacked on a leading axis in place (one
    layer of scratch, not a second copy of the stack)."""
    first = _map_tree(lambda t: t.to(device), fn())
    out = _map_tree(lambda t: torch.empty((n,) + tuple(t.shape),
                                          dtype=t.dtype, device=device),
                    first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    put(out, first, 0)
    for i in range(1, n):
        put(out, fn(), i)
    return out


def _dense_layer_init(gen, cfg, dtype):
    dev = gen.device
    p = {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "attn": attn_init(gen, cfg, dtype, bias=cfg.attn_bias),
        "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if cfg.mlp == "swiglu":
        p["mlp"] = {
            "w_gate": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_up": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_down": linear_init(gen, cfg.d_ff, cfg.d_model, dtype),
        }
    else:  # gelu
        p["mlp"] = {
            "w_up": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "b_up": torch.zeros((cfg.d_ff,), dtype=dtype, device=dev),
            "w_down": linear_init(gen, cfg.d_ff, cfg.d_model, dtype),
            "b_down": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
    return p


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random params with the reference's distributions, drawn from
    ``generator`` on its own device and placed on ``device`` (default: the
    GPU, see resolve_device).  A CUDA generator draws full-width weights
    on the card directly."""
    _require_dense(cfg, "init_params")
    dev = resolve_device(device)
    dtype = cfg.pdtype
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                            dtype).to(dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(generator, cfg.d_model,
                                        cfg.padded_vocab, dtype).to(dev)
    params["layers"] = _stacked_init(
        lambda: _dense_layer_init(generator, cfg, dtype), cfg.n_layers, dev)
    return params


# ---------------------------------------------------------------------------
# forward (prefill); returns (logits, aux)
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    x = params["embed"][tokens].to(cfg.dtype)
    if cfg.emb_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def _lm_logits(params, cfg, x):
    """Final norm, then the head (the embedding transposed when tied) cast
    to the compute dtype (a cached QWeight head ignores the cast), f32
    logits, optional tanh softcap."""
    x = apply_norm(x, params["final_norm"], cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if not isinstance(w, QWeight):
        w = w.to(cfg.dtype)
    logits = dense(x, w, policy=cfg.policy).to(torch.float32)
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def _mlp_apply(p, x, cfg):
    if "w_gate" in p:
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                      policy=cfg.policy)
    return gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"],
                    policy=cfg.policy)


def _dense_stack_forward(params, cfg, x, positions, *, collect_kv=False):
    """The dense layer stack, one layer at a time.

    Returns (x, aux, ys); with ``collect_kv`` ys is the stacked cached
    (k, v) per layer (post k-norm, post rope), (L, b, hkv, s, dh) each.
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = x
        hn1 = apply_norm(h, lp["norm1"], cfg.norm)
        a, _ = attention(lp["attn"], hn1, cfg, positions=positions,
                         use_kernel=cfg.use_flash_kernel)
        if cfg.parallel_block:
            # command-r style: shared norm, attn and mlp branches summed
            x = h + a + _mlp_apply(lp["mlp"], hn1, cfg)
        else:
            h = h + a
            x = h + _mlp_apply(lp["mlp"], apply_norm(h, lp["norm2"],
                                                     cfg.norm), cfg)
        if collect_kv:
            # re-derive the cached K/V from the layer's input
            b, s, _ = hn1.shape
            hkv, dh = cfg.n_kv_heads, cfg.head_dim
            k = dense(hn1, lp["attn"]["wk"], policy=cfg.policy,
                      bias=lp["attn"].get("bk")).reshape(b, s, hkv, dh)
            v = dense(hn1, lp["attn"]["wv"], policy=cfg.policy,
                      bias=lp["attn"].get("bv")).reshape(b, s, hkv, dh)
            if "k_norm" in lp["attn"]:
                k = rms_norm(k, lp["attn"]["k_norm"]["w"])
            k = rope(k, positions, theta=cfg.rope_theta)
            ks.append(k.transpose(1, 2))
            vs.append(v.transpose(1, 2))
    ys = (torch.stack(ks), torch.stack(vs)) if collect_kv else ()
    return x, aux, ys


@torch.inference_mode()
def forward(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Prefill forward: ``batch["tokens"]`` (b, s) -> (f32 logits (b, s, V),
    aux)."""
    _require_dense(cfg, "forward")
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    positions = torch.arange(s, device=x.device)
    x, aux, _ = _dense_stack_forward(params, cfg, x, positions)
    return _lm_logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode: cache init + serve_step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Zeroed KV cache {"kv": KVCache((L, b, hkv, max_len, dh) x 2)}."""
    _require_dense(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"kv": KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                          torch.zeros(shape, dtype=dtype, device=dev))}


@torch.inference_mode()
def serve_step(params, cfg: ModelConfig, cache, tokens, pos,
               write_mask=None):
    """One decode step: tokens (b, s), pos (the first token's position)
    -> (logits (b, s, V), new cache).

    ``write_mask`` (optional, bool (b,)): rows allowed to change the cache.
    The raw step writes every row's K/V at ``pos``; with a mask, rows
    outside it keep their previous cache bit for bit (their logits are
    still computed and must be ignored).  ``None`` keeps the raw
    semantics.  The input cache is not modified.
    """
    logits, new_cache = _serve_step_all_rows(params, cfg, cache, tokens, pos)
    if write_mask is not None:
        mask = torch.as_tensor(write_mask, dtype=torch.bool,
                               device=logits.device)

        def keep(new, old):
            # every cache leaf carries batch on axis 1: (L, b, ...)
            m = mask.reshape((1, -1) + (1,) * (new.ndim - 2))
            return torch.where(m, new, old)

        kv, old = new_cache["kv"], cache["kv"]
        new_cache = {"kv": KVCache(keep(kv.k, old.k), keep(kv.v, old.v))}
    return logits, new_cache


def _serve_step_all_rows(params, cfg: ModelConfig, cache, tokens, pos):
    _require_dense(cfg, "serve_step")
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    positions = pos + torch.arange(s, device=x.device)
    kv = cache["kv"]
    nk, nv = torch.empty_like(kv.k), torch.empty_like(kv.v)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        hn1 = apply_norm(x, lp["norm1"], cfg.norm)
        a, new_kv = attention(lp["attn"], hn1, cfg, positions=positions,
                              cache=KVCache(kv.k[i], kv.v[i]), start=pos)
        nk[i], nv[i] = new_kv.k, new_kv.v
        if cfg.parallel_block:
            x = x + a + _mlp_apply(lp["mlp"], hn1, cfg)
        else:
            h = x + a
            x = h + _mlp_apply(lp["mlp"], apply_norm(h, lp["norm2"],
                                                     cfg.norm), cfg)
    return _lm_logits(params, cfg, x), {"kv": KVCache(nk, nv)}
