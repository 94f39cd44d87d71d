"""Unified model configuration covering all assigned architecture families."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention variants
    window: int = 0                  # sliding-window size (0 = disabled)
    global_every: int = 0            # 1 global layer per N (gemma3 local:global)
    global_layers: tuple = ()        # explicit global-attention layer ids (hymba)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0

    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM (rwkv6 / hymba-mamba)
    ssm_state: int = 0
    n_ssm_heads: int = 0

    # enc-dec (whisper) / vlm (llama-3.2-vision)
    n_encoder_layers: int = 0
    n_media_tokens: int = 0          # stub frontend sequence length
    cross_every: int = 0             # vlm: one cross-attn layer per N layers

    # embeddings / numerics
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # distribution knobs (overridable per-arch; see distributed/sharding.py)
    remat: str = "full"              # full | dots | none
    # attention impl: "chunked" = flash-style online-softmax lax.scan over KV
    # blocks (bounded memory; the XLA twin of kernels/flash_attention);
    # "dense" materializes (S, T) scores.  Chunked kicks in for T >= 2*kblock.
    attention_impl: str = "chunked"
    attention_kblock: int = 512
    # chunked path engages at T >= this (at 4k, dense XLA attention moves
    # fewer HBM bytes than the scan-carried online-softmax accumulators; on
    # real TPU the Pallas flash kernel covers training — kernels/flash_attention)
    attention_chunk_min_t: int = 8192
    # MoE dispatch: "grid" = capacity-factor gather grid (expert-parallel);
    # "ragged" = dropless ragged_dot with replicated expert weights (right
    # for many-small-experts models like granite — compute stays local).
    moe_impl: str = "grid"
    # pad vocab so the "model" mesh axis divides it (Megatron-style padding)
    pad_vocab_multiple: int = 128

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def is_global_layer(self, i: int) -> bool:
        """Static per-layer attention kind (drives the scanned flag array)."""
        if self.window <= 0:
            return True
        if self.global_layers:
            return i in self.global_layers
        if self.global_every > 0:
            return (i % self.global_every) == (self.global_every - 1)
        return False

    def n_params_dense_equivalent(self) -> int:
        """Rough total parameter count N for MODEL_FLOPS = 6*N*D accounting
        (active params for MoE — see benchmarks/roofline.py)."""
        raise NotImplementedError  # computed from templates; see models/*
