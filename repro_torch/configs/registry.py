"""Config registry: ``--arch <id>`` resolves here.

The port of ``repro.configs.registry``: the eleven transformer-zoo configs
(exact public configs, as data) and the paper's CNNs.  ``reduced(cfg)``
shrinks any config to a CPU-test size of the same family.  Of the LM
families only ``dense`` runs in the port so far; the others raise
``not_ported`` at ``init_params``/``forward``/``init_cache``
(:mod:`repro_torch.models.transformer`).
"""
from __future__ import annotations

from typing import Callable, Dict, Union

from repro_torch.models.cnn import (ALEXNET, VGG16, VGG19, CNNConfig,
                                    cnn_reduced)
from repro_torch.models.config import ModelConfig

AnyConfig = Union[ModelConfig, CNNConfig]

_LM: Dict[str, ModelConfig] = {c.name: c for c in (
    # [audio] enc-dec; conv frontend stubbed (precomputed frame embeddings)
    ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        head_dim=64, d_ff=5120, vocab_size=51866,
        norm="ln", mlp="gelu", attn_bias=True, tie_embeddings=True,
        rope_theta=10000.0, enc_seq=1500),
    ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92544, rope_theta=1e6),
    ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=49155, tie_embeddings=True, rope_theta=10000.0),
    ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab_size=102400, rope_theta=10000.0),
    ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=33792, vocab_size=256000,
        parallel_block=True, tie_embeddings=True, rope_theta=75e4),
    # [vlm] InternViT frontend stubbed (precomputed patch embeddings)
    ModelConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, rope_theta=1e6, n_img_tokens=256),
    # sLSTM + mLSTM blocks; 12 layers as 3 scanned groups of (m,m,m,s)
    ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
        d_ff=0, vocab_size=50304,
        xlstm_group=("m", "m", "m", "s"), n_xlstm_groups=3,
        tie_embeddings=True),
    # RG-LRU + local attention: 12 groups of (rglru, rglru, attn) + 2 tail
    ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000,
        rnn_width=4096, local_window=2048,
        pattern_group=("rglru", "rglru", "attn"),
        n_pattern_groups=12, n_tail_layers=2,
        tie_embeddings=True, emb_scale=True, logits_softcap=30.0,
        rope_theta=10000.0),
    ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab_size=151936,
        moe_num_experts=128, moe_top_k=8, qk_norm=True, rope_theta=1e6),
    ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab_size=50304,
        moe_num_experts=64, moe_top_k=8, qk_norm=True, rope_theta=10000.0),
)}

_REGISTRY: Dict[str, Callable[[], AnyConfig]] = {
    **{name: (lambda c=c: c) for name, c in _LM.items()},
    "alexnet": lambda: ALEXNET,
    "vgg16": lambda: VGG16,
    "vgg19": lambda: VGG19,
}

CNN_ARCHS = sorted(n for n in _REGISTRY if n not in _LM)
#: transformer-zoo archs only (CNNs live in CNN_ARCHS)
ARCHS = sorted(_LM)


def list_configs():
    return sorted(_REGISTRY)


def get_config(name: str, **overrides) -> AnyConfig:
    cfg = _REGISTRY[name]()
    return cfg.replace(**overrides) if overrides else cfg


def reduced(cfg: AnyConfig) -> AnyConfig:
    """CPU-test size of the same config and family (the reference's rule)."""
    if isinstance(cfg, CNNConfig):
        return cnn_reduced(cfg)
    kw = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab_size=256,
        vocab_pad_to=64, moe_group_size=64,
    )
    if cfg.family == "moe":
        kw.update(moe_num_experts=8, moe_top_k=2, d_ff=32,
                  moe_capacity_factor=4.0)
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_seq=16)
    if cfg.family == "vlm":
        kw.update(n_img_tokens=4)
    if cfg.family == "hybrid":
        kw.update(rnn_width=64, local_window=8, n_pattern_groups=2,
                  n_tail_layers=1, n_layers=7)
    if cfg.family == "ssm":
        kw.update(n_xlstm_groups=1, n_layers=4, head_dim=32)
    return cfg.replace(**kw)
