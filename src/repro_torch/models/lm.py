"""Decoder-only LM, dense and MoE: qwen2-1.5b (QKV bias), qwen3-8b
(qk-norm GQA), mistral-nemo-12b, gemma3-12b (5:1 local:global sliding
window, logit softcap in ``unembed``), granite-moe-3b (40-expert MoE).  The
MLA configs of the reference's ``lm`` (deepseek-v2) are not ported yet
(:func:`repro_torch.models.common.get_family` refuses them).

The layers are a Python loop over ``model.layers`` (an ``nn.ModuleList``),
where the reference scans a stacked tree; the per-layer attention kind
(local or global) is ``cfg.is_global_layer(i)``.  Prefill attention runs on
K5 (see :func:`repro_torch.nn.layers.attention_core`).  The MoE layer runs
the config's capacity grid in ``forward`` and ``prefill`` and the dropless
form in ``decode_step``, as the reference's; ``routing``, a list, collects
each MoE layer's :class:`repro_torch.nn.layers.Routing`.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import common as C
from repro_torch.nn import layers as L
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import stack_template


def layer_template(cfg: ModelConfig):
    if cfg.use_mla:
        raise NotImplementedError(C.not_ported("MLA attention"))
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ffn": L.moe_template(cfg) if cfg.is_moe else L.mlp_template(cfg),
    }


def template(cfg: ModelConfig):
    return {
        "embed": C.embed_template(cfg),
        "layers": stack_template(layer_template(cfg), cfg.n_layers),
    }


def build(cfg: ModelConfig, device=None, dtype=None) -> C.Model:
    return C.Model(cfg, layer_template, dtype, device)


def _ffn(p, cfg: ModelConfig, x, dropless=False, routing=None):
    if cfg.is_moe:
        return L.moe_apply(p, cfg, x, dropless=dropless, routing=routing)
    return L.mlp_apply(p, x)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(B, S)


def forward(model, cfg: ModelConfig, tokens, media=None, routing=None):
    """Teacher-forcing forward -> logits (B,S,V); positions ``arange(S)``."""
    del media
    positions = _positions(tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + L.attention_apply(lp["attn"], cfg, h, positions,
                                  cfg.is_global_layer(i))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(lp["ffn"], cfg, h, routing=routing)
    return C.unembed(model.embed, cfg, x)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero K/V caches (L, B, T, K, D), the reference's layout."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, media=None):
    """One-token decode. tokens: (B,1); pos: a 1-element int64 tensor on
    the cache's device (the reference's traced ``int32``) or an int.
    Returns (logits (B,1,V), cache), the cache updated in place at ``pos``;
    nothing reads the host, so a CUDA graph can capture the step."""
    del media
    pos = L.decode_position(pos, tokens.device)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos,
                                     cfg.is_global_layer(i))
        x = x + h
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(lp["ffn"], cfg, h, dropless=True)
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None,
            routing=None):
    """Full-sequence prefill -> (logits of the last position, the bf16 K/V
    cache of ``max_seq`` positions, the first S filled)."""
    del media
    B, S = tokens.shape
    positions = _positions(tokens)
    cache = init_cache(cfg, B, max_seq or S, device=tokens.device)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions)
        out = L.attention_core(cfg, q, k, v, cfg.is_global_layer(i))
        x = x + L._out_proj(lp["attn"], out)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(lp["ffn"], cfg, h, routing=routing)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("dense")(sys.modules[__name__])
C.register_family("moe")(sys.modules[__name__])
