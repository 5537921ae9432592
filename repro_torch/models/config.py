"""ModelConfig: one dataclass describing every transformer-zoo architecture.

The port of ``repro.models.config``, field for field, with the dtypes
resolved to torch dtypes (:attr:`ModelConfig.dtype`, :attr:`~ModelConfig.pdtype`).
The distribution fields (``act_dp``, ``seq_shard``, ``tp_mode``,
``shard_mode``) and the rematerialization fields (``remat``,
``remat_policy``) are kept as data so configs carry across unchanged; the
port has no mesh and no training step yet, so nothing reads them
(ROADMAP.md, Queue 1, "Training and distribution").
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.precision import MatmulPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention / norm options
    norm: str = "rms"              # rms | ln
    rope_theta: float = 1e6
    qk_norm: bool = False
    attn_bias: bool = False
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    parallel_block: bool = False   # command-r style: x + attn(n(x)) + mlp(n(x))

    # precision: the paper's technique is selected here
    policy: MatmulPolicy = MatmulPolicy.NATIVE_BF16
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_group_size: int = 512
    moe_capacity_factor: float = 1.25

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0

    # VLM (internvl2)
    n_img_tokens: int = 0

    # hybrid (recurrentgemma): groups of (rglru, rglru, attn) + rglru tail
    rnn_width: int = 0
    local_window: int = 0
    pattern_group: Tuple[str, ...] = ()
    n_pattern_groups: int = 0
    n_tail_layers: int = 0

    # xlstm: in each scanned group of len(xlstm_group) layers, which are sLSTM
    xlstm_group: Tuple[str, ...] = ()
    n_xlstm_groups: int = 0

    # distribution (data only in the port: no mesh yet)
    act_dp: Tuple[str, ...] = ()
    seq_shard: bool = False
    tp_mode: str = "auto"
    shard_mode: str = "auto"

    # attention lowering: flash-style chunked scan above this KV length
    attn_dense_max: int = 2048
    attn_chunk: int = 1024

    # misc
    vocab_pad_to: int = 256
    use_flash_kernel: bool = False
    remat: bool = False
    remat_policy: str = "full"
    logits_softcap: float = 0.0
    emb_scale: bool = False
    max_seq_len: int = 8192

    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab_size, self.vocab_pad_to
        return -(-v // p) * p

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One (input-shape) cell from the assignment."""
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}
