"""Model assembly for the transformer zoo: the dense, MoE, xLSTM
(``ssm``), VLM and encoder-decoder families (the port of
``repro.models.transformer``).

Params keep the reference's pytree layout: a dict whose ``"layers"``
leaves (dense and VLM; MoE with ``"moe"`` in place of ``"mlp"``),
``"enc_layers"``/``"dec_layers"`` leaves (encdec: the decoder's layers
add ``"norm_x"`` and the cross-attention ``"xattn"``) or
``"groups"``/``"b{i}"`` leaves (ssm: one entry per member of the (m, m,
m, s) group) are STACKED (leading layer or group axis), so a test
can carry params across as they are.  Where the reference scans the stack
with ``lax.scan``, the port loops in Python (:func:`layer_params` slices
one layer or group).

Public API (same names as the reference):
  init_params(cfg, generator)      -> params dict
  forward(params, cfg, batch)      -> (logits, aux)      [prefill]
  init_cache(cfg, batch, max_len)  -> decode cache dict
  encode(params, cfg, audio_embeds, cache) -> cache with ``cross_kv``
  serve_step(params, cfg, cache, tokens, pos, write_mask) -> (logits, cache)

The VLM's ``forward`` replaces the first ``n_img_tokens`` token
embeddings with ``batch["img_embeds"]``; its decode runs the dense stack
(the reference's serve steps pass no images).  The encoder-decoder's
``forward`` encodes ``batch["audio_embeds"]`` (non-causal, no cache) and
cross-attends to it from every decoder layer; its decode reads the
cross K/V that :func:`encode` put in the cache.  The hybrid family raises
``not_ported`` (ROADMAP.md, Queue 1, "LM side: the other families"), and
``loss_fn`` waits for the training slice.  An MoE layer's aux loss is
summed over layers in f32 and returned by :func:`forward`, as the
reference's scan carries it.  Entry points run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.substrate import QWeight, not_ported
from repro_torch.device import resolve_device

from .attention import KVCache, attention, attn_init
from .config import ModelConfig
from . import moe
from .layers import (apply_norm, dense, embed_init, gelu_mlp, linear_init,
                     norm_init, rms_norm, rope, swiglu)
from .ssm import (MLSTMState, SLSTMState, mlstm_block, mlstm_init,
                  slstm_block, slstm_init, slstm_state0)

#: The ROADMAP.md item each family that is not ported yet waits for.
_FAMILY_ITEM = {
    "hybrid": "Queue 1, LM side: the hybrid family (RG-LRU in "
              "models/ssm.py)",
}
_PORTED = ("dense", "moe", "ssm", "vlm", "encdec")


def _require_ported(cfg: ModelConfig, what: str) -> None:
    if cfg.family in _PORTED:
        return
    if cfg.family in _FAMILY_ITEM:
        raise not_ported(f"{what} for family {cfg.family!r}",
                         _FAMILY_ITEM[cfg.family])
    raise ValueError(cfg.family)


def map_tree(fn, *trees):
    """``fn`` over the matching leaves of param or cache trees (dicts and
    NamedTuples of tensors or QWeights), as ``jax.tree.map`` walks them."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return type(t0)(*(map_tree(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked param tree (tensors and QWeights)."""
    return map_tree(lambda t: t[i], stacked)


def params_to(params, device):
    """Every tensor / QWeight of a param tree moved to ``device``."""
    return map_tree(lambda t: t.to(device), params)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked_init(fn, n: int, device):
    """``fn()`` drawn ``n`` times, stacked on a leading axis in place (one
    layer of scratch, not a second copy of the stack)."""
    first = map_tree(lambda t: t.to(device), fn())
    out = map_tree(lambda t: torch.empty((n,) + tuple(t.shape),
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
    if cfg.family == "moe":
        p["moe"] = moe.moe_init(gen, cfg, dtype)
    elif cfg.mlp == "swiglu":
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


def _enc_layer_init(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "attn": attn_init(gen, cfg, dtype, bias=cfg.attn_bias),
        "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": {
            "w_up": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "b_up": torch.zeros((cfg.d_ff,), dtype=dtype, device=dev),
            "w_down": linear_init(gen, cfg.d_ff, cfg.d_model, dtype),
            "b_down": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        },
    }


def _dec_layer_init(gen, cfg, dtype):
    p = _enc_layer_init(gen, cfg, dtype)
    p["norm_x"] = norm_init(cfg.d_model, cfg.norm, dtype, gen.device)
    p["xattn"] = attn_init(gen, cfg, dtype, bias=cfg.attn_bias)
    return p


def _xlstm_block_init(gen, cfg, kind, dtype):
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, gen.device),
        "mixer": (mlstm_init(gen, cfg, dtype) if kind == "m"
                  else slstm_init(gen, cfg, dtype)),
    }


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random params with the reference's distributions, drawn from
    ``generator`` on its own device and placed on ``device`` (default: the
    GPU, see resolve_device).  A CUDA generator draws full-width weights
    on the card directly."""
    _require_ported(cfg, "init_params")
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
    if cfg.family == "ssm":
        params["groups"] = {
            f"b{i}": _stacked_init(
                lambda kind=kind: _xlstm_block_init(generator, cfg, kind,
                                                    dtype),
                cfg.n_xlstm_groups, dev)
            for i, kind in enumerate(cfg.xlstm_group)}
        return params
    if cfg.family == "encdec":
        params["enc_layers"] = _stacked_init(
            lambda: _enc_layer_init(generator, cfg, dtype),
            cfg.n_enc_layers, dev)
        params["enc_final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype,
                                             dev)
        params["dec_layers"] = _stacked_init(
            lambda: _dec_layer_init(generator, cfg, dtype), cfg.n_layers,
            dev)
        return params
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


def _ffn_apply(lp, hn, cfg):
    """The layer's FFN on the normed input: (out, the MoE aux loss or
    None)."""
    if cfg.family == "moe":
        return moe.moe_ffn(lp["moe"], hn, cfg)
    return _mlp_apply(lp["mlp"], hn, cfg), None


def _dense_stack_forward(params, cfg, x, positions, *, collect_kv=False):
    """The dense (and MoE) layer stack, one layer at a time.

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
            m, l_aux = _ffn_apply(lp, apply_norm(h, lp["norm2"], cfg.norm),
                                  cfg)
            if l_aux is not None:
                aux = aux + l_aux
            x = h + m
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
    _require_ported(cfg, "forward")
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x, _ = _xlstm_stack(params, cfg, x)
        return _lm_logits(params, cfg, x), zero
    positions = torch.arange(s, device=x.device)
    if cfg.family == "encdec":
        enc = _encoder(params, cfg, batch["audio_embeds"])
        for i in range(cfg.n_layers):
            lp = layer_params(params["dec_layers"], i)
            x = _dec_layer(lp, cfg, x, positions,
                           kv=_cross_kv(lp["xattn"], cfg, enc))[0]
        return _lm_logits(params, cfg, x), zero
    if cfg.family == "vlm":
        # the image embeddings REPLACE the first n_img_tokens positions
        img = torch.as_tensor(batch["img_embeds"], device=dev).to(cfg.dtype)
        x = torch.cat([img, x[:, cfg.n_img_tokens:]], dim=1)
    x, aux, _ = _dense_stack_forward(params, cfg, x, positions)
    return _lm_logits(params, cfg, x), aux


def _encoder(params, cfg, audio_embeds):
    """The encoder stack over precomputed frame embeddings (b, enc_seq, d):
    non-causal self-attention (the flash kernel when
    ``cfg.use_flash_kernel``), no cache, then ``enc_final_norm``."""
    dev = params["embed"].device
    x = torch.as_tensor(audio_embeds, device=dev).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=dev)
    for i in range(cfg.n_enc_layers):
        lp = layer_params(params["enc_layers"], i)
        a, _ = attention(lp["attn"], apply_norm(x, lp["norm1"], cfg.norm),
                         cfg, positions=positions, causal=False,
                         use_kernel=cfg.use_flash_kernel)
        x = x + a
        x = x + _mlp_apply(lp["mlp"], apply_norm(x, lp["norm2"], cfg.norm),
                           cfg)
    return apply_norm(x, params["enc_final_norm"], cfg.norm)


def _cross_kv(xp, cfg, enc):
    """A decoder layer's cross-attention K/V of the encoder output, (b,
    hkv, enc_seq, dh) each, biases included."""
    b = enc.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    k = dense(enc, xp["wk"], policy=cfg.policy, bias=xp.get("bk"))
    v = dense(enc, xp["wv"], policy=cfg.policy, bias=xp.get("bv"))
    return (k.reshape(b, -1, hkv, dh).transpose(1, 2),
            v.reshape(b, -1, hkv, dh).transpose(1, 2))


def _dec_layer(lp, cfg, x, positions, *, kv, cache=None, start=None):
    """One decoder layer: causal self-attention (on ``cache`` when given,
    else on the flash kernel when ``cfg.use_flash_kernel``),
    cross-attention on ``kv`` (no rope, every key live), the GELU MLP.
    Returns (x, the new self-attention cache or None)."""
    a, new_kv = attention(lp["attn"], apply_norm(x, lp["norm1"], cfg.norm),
                          cfg, positions=positions, cache=cache, start=start,
                          use_kernel=cfg.use_flash_kernel)
    x = x + a
    a, _ = attention(lp["xattn"], apply_norm(x, lp["norm_x"], cfg.norm), cfg,
                     positions=positions, causal=False, use_rope=False,
                     kv_override=kv)
    x = x + a
    x = x + _mlp_apply(lp["mlp"], apply_norm(x, lp["norm2"], cfg.norm), cfg)
    return x, new_kv


def _xlstm_stack(params, cfg, x, states=None):
    """The xLSTM groups, a Python loop over groups and their members.

    ``states`` None: prefill from fresh states (returns no states).  Else
    the decode cache's ``groups`` (leaves (G, b, ...)); returns the new
    states in the same layout.
    """
    new = {f"b{i}": [] for i in range(len(cfg.xlstm_group))}
    for g in range(cfg.n_xlstm_groups):
        for i, kind in enumerate(cfg.xlstm_group):
            name = f"b{i}"
            bp = layer_params(params["groups"][name], g)
            st = None if states is None else \
                type(states[name])(*(t[g] for t in states[name]))
            hn = apply_norm(x, bp["norm1"], cfg.norm)
            block = mlstm_block if kind == "m" else slstm_block
            m, st = block(bp["mixer"], hn, cfg, state=st)
            x = x + m
            new[name].append(st)
    if states is None:
        return x, None
    return x, {name: type(sts[0])(*(torch.stack(f) for f in zip(*sts)))
               for name, sts in new.items()}


# ---------------------------------------------------------------------------
# decode: cache init + serve_step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None):
    """Dense, MoE and VLM: a zeroed KV cache {"kv": KVCache((L, b, hkv,
    max_len, dh) x 2)}; encdec adds {"cross_kv": KVCache((L, b, hkv,
    enc_seq, dh) x 2)}, zero until :func:`encode`.  ssm: {"groups":
    {"b{i}": MLSTMState | SLSTMState}}, leaves (G, b, ...), zero but the
    sLSTM normalizer, which starts at ones (``max_len`` is not used: the
    state has no positions)."""
    _require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    if cfg.family == "ssm":
        return {"groups": _xlstm_cache(cfg, batch, dtype, dev)}

    def kv(length):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, length, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev))

    if cfg.family == "encdec":
        # cross_kv is filled by encode()
        return {"kv": kv(max_len), "cross_kv": kv(cfg.enc_seq)}
    return {"kv": kv(max_len)}


@torch.inference_mode()
def encode(params, cfg: ModelConfig, audio_embeds, cache):
    """Run the encoder and fill the decoder's cross-attention cache: every
    decoder layer's ``xattn`` K/V of the encoder output, in the compute
    dtype, ``(L, b, hkv, enc_seq, dh)`` each (the input cache is not
    modified)."""
    _require_ported(cfg, "encode")
    enc = _encoder(params, cfg, audio_embeds)
    b, s = enc.shape[:2]
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    ks = torch.empty(shape, dtype=cfg.dtype, device=enc.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        ks[i], vs[i] = _cross_kv(
            layer_params(params["dec_layers"], i)["xattn"], cfg, enc)
    return {**cache, "cross_kv": KVCache(ks, vs)}


def _xlstm_cache(cfg, batch, dtype, dev):
    g, d = cfg.n_xlstm_groups, cfg.d_model
    di, h = 2 * d, cfg.n_heads
    dh = di // h
    f32 = torch.float32
    groups = {}
    for i, kind in enumerate(cfg.xlstm_group):
        if kind == "m":
            groups[f"b{i}"] = MLSTMState(
                torch.zeros((g, batch, h, dh, dh), dtype=f32, device=dev),
                torch.zeros((g, batch, h, dh), dtype=f32, device=dev),
                torch.zeros((g, batch, 3, di), dtype=dtype, device=dev))
        else:
            groups[f"b{i}"] = SLSTMState(*(
                t[None].expand(g, batch, d).clone()
                for t in slstm_state0(1, d, dev)))
    return groups


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
            # every cache/state leaf carries batch on axis 1:
            # (n_layers|n_groups, b, ...) -- masked rows keep the old value
            if new is old:  # a leaf the step passes through (cross_kv)
                return old
            m = mask.reshape((1, -1) + (1,) * (new.ndim - 2))
            return torch.where(m, new, old)

        new_cache = map_tree(keep, new_cache, cache)
    return logits, new_cache


def _serve_step_all_rows(params, cfg: ModelConfig, cache, tokens, pos):
    _require_ported(cfg, "serve_step")
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    if cfg.family == "ssm":
        x, groups = _xlstm_stack(params, cfg, x, cache["groups"])
        return _lm_logits(params, cfg, x), {"groups": groups}
    positions = pos + torch.arange(s, device=x.device)
    kv = cache["kv"]
    nk, nv = torch.empty_like(kv.k), torch.empty_like(kv.v)
    if cfg.family == "encdec":
        xkv = cache["cross_kv"]
        for i in range(cfg.n_layers):
            x, new_kv = _dec_layer(
                layer_params(params["dec_layers"], i), cfg, x, positions,
                kv=(xkv.k[i], xkv.v[i]), cache=KVCache(kv.k[i], kv.v[i]),
                start=pos)
            nk[i], nv[i] = new_kv.k, new_kv.v
        return _lm_logits(params, cfg, x), {"kv": KVCache(nk, nv),
                                            "cross_kv": xkv}
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
            x = h + _ffn_apply(lp, apply_norm(h, lp["norm2"], cfg.norm),
                               cfg)[0]
    return _lm_logits(params, cfg, x), {"kv": KVCache(nk, nv)}
