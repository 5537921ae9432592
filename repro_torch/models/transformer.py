"""Model assembly for the transformer zoo: the dense, MoE, xLSTM
(``ssm``), hybrid, VLM and encoder-decoder families (the port of
``repro.models.transformer``).

Params keep the reference's pytree layout: a dict whose ``"layers"``
leaves (dense and VLM; MoE with ``"moe"`` in place of ``"mlp"``),
``"enc_layers"``/``"dec_layers"`` leaves (encdec: the decoder's layers
add ``"norm_x"`` and the cross-attention ``"xattn"``) or
``"groups"``/``"b{i}"`` leaves (ssm: one entry per member of the (m, m,
m, s) group; hybrid: per member of the (rglru, rglru, attn) group, plus a
``"tail"`` of RG-LRU blocks) are STACKED (leading layer or group axis), so
a test can carry params across as they are.  Where the reference scans the
stack with ``lax.scan``, the port loops in Python (:func:`layer_params`
slices one layer or group).

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
cross K/V that :func:`encode` put in the cache.  The hybrid family's
blocks are an RG-LRU or a local (sliding-window) attention mixer, then a
GeGLU MLP; its prefill attends through ``window=local_window`` (the flash
kernel when ``cfg.use_flash_kernel``), its decode through a ring buffer
of ``min(local_window, max_len)`` slots (:func:`_ring_local_attention`).
An unknown family raises ``ValueError``, as in the reference;
``loss_fn`` waits for the training slice.  An MoE layer's aux loss is
summed over layers in f32 and returned by :func:`forward`, as the
reference's scan carries it.  Entry points run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.substrate import QWeight
from repro_torch.device import resolve_device

from .attention import NEG_INF, KVCache, attention, attn_init
from .config import ModelConfig
from . import moe
from .layers import (apply_norm, dense, embed_init, gelu_mlp, linear_init,
                     norm_init, rms_norm, rope, swiglu)
from .ssm import (MLSTMState, RGLRUState, SLSTMState, mlstm_block,
                  mlstm_init, rglru_block, rglru_init, slstm_block,
                  slstm_init, slstm_state0)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
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


def _glu_mlp_init(gen, cfg, dtype):
    return {
        "w_gate": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "w_up": linear_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "w_down": linear_init(gen, cfg.d_ff, cfg.d_model, dtype),
    }


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
        p["mlp"] = _glu_mlp_init(gen, cfg, dtype)
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


def _hybrid_block_init(gen, cfg, kind, dtype):
    dev = gen.device
    return {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "mixer": (rglru_init(gen, cfg, dtype) if kind == "rglru"
                  else attn_init(gen, cfg, dtype)),
        "norm2": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": _glu_mlp_init(gen, cfg, dtype),
    }


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
    _check_family(cfg)
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
    if cfg.family == "hybrid":
        params["groups"] = {
            f"b{i}": _stacked_init(
                lambda kind=kind: _hybrid_block_init(generator, cfg, kind,
                                                     dtype),
                cfg.n_pattern_groups, dev)
            for i, kind in enumerate(cfg.pattern_group)}
        if cfg.n_tail_layers:
            params["tail"] = _stacked_init(
                lambda: _hybrid_block_init(generator, cfg, "rglru", dtype),
                cfg.n_tail_layers, dev)
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
        # in place: the logits are the forward's largest tensor (4 x 2048
        # x 256000 f32 is 8.4 GB), and ``logits`` is a fresh product
        c = cfg.logits_softcap
        logits.div_(c).tanh_().mul_(c)
    return logits


def _mlp_apply(p, x, cfg):
    if "w_gate" in p:
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                      policy=cfg.policy)
    return gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"],
                    policy=cfg.policy)


def _geglu(p, x, cfg):
    g = dense(x, p["w_gate"], policy=cfg.policy)
    u = dense(x, p["w_up"], policy=cfg.policy)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype) * u
    return dense(h, p["w_down"], policy=cfg.policy)


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
    _check_family(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x, _ = _xlstm_stack(params, cfg, x)
        return _lm_logits(params, cfg, x), zero
    positions = torch.arange(s, device=x.device)
    if cfg.family == "hybrid":
        x, _ = _hybrid_stack(params, cfg, x, positions)
        return _lm_logits(params, cfg, x), zero
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


def _hybrid_block(bp, cfg, kind, x, positions, state=None, pos=None):
    """One hybrid block: the mixer on the normed input (RG-LRU, or local
    attention: windowed over ``positions`` in prefill, the ring buffer
    ``state`` at ``pos`` in decode), then the GeGLU MLP.  Returns (x, the
    mixer's new state or None)."""
    hn = apply_norm(x, bp["norm1"], cfg.norm)
    if kind == "rglru":
        m, st = rglru_block(bp["mixer"], hn, cfg, state=state)
    elif state is None:
        m, st = attention(bp["mixer"], hn, cfg, positions=positions,
                          window=cfg.local_window,
                          use_kernel=cfg.use_flash_kernel)
    else:
        m, st = _ring_local_attention(
            bp["mixer"], hn, cfg, state, pos,
            min(cfg.local_window, state.k.shape[2]))
    x = x + m
    x = x + _geglu(bp["mlp"], apply_norm(x, bp["norm2"], cfg.norm), cfg)
    return x, st


def _hybrid_stack(params, cfg, x, positions, cache=None, pos=None):
    """The hybrid groups, then the RG-LRU tail, a Python loop over both.

    ``cache`` None: prefill (returns no states).  Else the decode cache
    (``groups`` leaves (G, b, ...), ``tail`` leaves (T, b, ...)); returns
    the new ``{"groups": ..., "tail": ...}`` in the same layout.
    """
    def at(st, i):
        return type(st)(*(t[i] for t in st))

    def stacked(sts):
        return type(sts[0])(*(torch.stack(f) for f in zip(*sts)))

    new = {f"b{i}": [] for i in range(len(cfg.pattern_group))}
    for g in range(cfg.n_pattern_groups):
        for i, kind in enumerate(cfg.pattern_group):
            name = f"b{i}"
            st = None if cache is None else at(cache["groups"][name], g)
            x, st = _hybrid_block(layer_params(params["groups"][name], g),
                                  cfg, kind, x, positions, st, pos)
            new[name].append(st)
    tail = []
    for t in range(cfg.n_tail_layers):
        st = None if cache is None else at(cache["tail"], t)
        x, st = _hybrid_block(layer_params(params["tail"], t), cfg,
                              "rglru", x, positions, st, pos)
        tail.append(st)
    if cache is None:
        return x, None
    return x, {"groups": {name: stacked(sts) for name, sts in new.items()},
               "tail": stacked(tail) if tail else cache["tail"]}


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
    state has no positions).  hybrid: {"groups": {"b{i}": RGLRUState
    (h (G, b, d_rnn) f32, conv (G, b, 3, d_rnn)) | KVCache (the ring,
    (G, b, hkv, min(local_window, max_len), dh) x 2)}, "tail":
    RGLRUState}, all zero."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    if cfg.family == "ssm":
        return {"groups": _xlstm_cache(cfg, batch, dtype, dev)}
    if cfg.family == "hybrid":
        return _hybrid_cache(cfg, batch, max_len, dtype, dev)

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
    _check_family(cfg)
    enc = _encoder(params, cfg, audio_embeds)
    b, s = enc.shape[:2]
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    ks = torch.empty(shape, dtype=cfg.dtype, device=enc.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        ks[i], vs[i] = _cross_kv(
            layer_params(params["dec_layers"], i)["xattn"], cfg, enc)
    return {**cache, "cross_kv": KVCache(ks, vs)}


def _hybrid_cache(cfg, batch, max_len, dtype, dev):
    di, f32 = cfg.rnn_width, torch.float32

    def rglru(n):
        return RGLRUState(
            torch.zeros((n, batch, di), dtype=f32, device=dev),
            torch.zeros((n, batch, 3, di), dtype=dtype, device=dev))

    shape = (cfg.n_pattern_groups, batch, cfg.n_kv_heads,
             min(cfg.local_window, max_len), cfg.head_dim)
    groups = {
        f"b{i}": rglru(cfg.n_pattern_groups) if kind == "rglru" else
        KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                torch.zeros(shape, dtype=dtype, device=dev))
        for i, kind in enumerate(cfg.pattern_group)}
    return {"groups": groups, "tail": rglru(cfg.n_tail_layers)}


def _ring_local_attention(lp, x, cfg, cache: KVCache, pos: int,
                          window: int):
    """Decode-step local attention over a ring buffer of ``window`` slots:
    x (b, 1, d), ``cache`` one layer's ring (b, hkv, window, dh) x 2.  The
    new K/V land in slot ``pos mod window`` (the row's other slots keep
    their bits); a slot is live iff the absolute position it holds, ``pos
    - ((pos - slot) mod window)``, lies in [0, pos]; masked scores are
    -1e30; the scores, softmax and P V run in f32 (GQA by group).
    Returns (y, the new ring)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"ring-buffer decode takes one token a step, got "
                         f"{s}")
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    policy = cfg.policy
    q = dense(x, lp["wq"], policy=policy).reshape(b, s, hq, dh)
    k = dense(x, lp["wk"], policy=policy).reshape(b, s, hkv, dh)
    v = dense(x, lp["wv"], policy=policy).reshape(b, s, hkv, dh)
    positions = pos + torch.arange(s, device=x.device)
    q = rope(q, positions, theta=cfg.rope_theta).transpose(1, 2)
    k = rope(k, positions, theta=cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    slot = pos % window
    ck, cv = cache.k.clone(), cache.v.clone()
    ck[:, :, slot:slot + 1] = k.to(ck.dtype)
    cv[:, :, slot:slot + 1] = v.to(cv.dtype)
    idx = torch.arange(window, device=x.device)
    k_pos = pos - torch.remainder(pos - idx, window)
    valid = (k_pos >= 0) & (k_pos <= pos)
    f32 = torch.float32
    qg = q.reshape(b, hkv, hq // hkv, s, dh)
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg.to(f32), ck.to(f32)) \
        / torch.full((), dh ** 0.5, dtype=f32, device=x.device)
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, cv.to(f32))
    o = o.reshape(b, hq, s, dh).transpose(1, 2).reshape(b, s, hq * dh)
    y = dense(o.to(x.dtype), lp["wo"], policy=policy)
    return y, KVCache(ck, cv)


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
    _check_family(cfg)
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    s = tokens.shape[1]
    x = _embed(params, cfg, tokens.long())
    if cfg.family == "ssm":
        x, groups = _xlstm_stack(params, cfg, x, cache["groups"])
        return _lm_logits(params, cfg, x), {"groups": groups}
    positions = pos + torch.arange(s, device=x.device)
    if cfg.family == "hybrid":
        x, new = _hybrid_stack(params, cfg, x, positions, cache, pos)
        return _lm_logits(params, cfg, x), new
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
