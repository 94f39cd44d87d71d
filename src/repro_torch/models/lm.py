"""Decoder-only LM, dense and MoE: qwen2-1.5b (QKV bias), qwen3-8b
(qk-norm GQA), mistral-nemo-12b, gemma3-12b (5:1 local:global sliding
window, logit softcap in ``unembed``), granite-moe-3b (40-expert MoE),
deepseek-v2-236b (MLA attention, 160-expert MoE with shared experts).

The layers are a Python loop over ``model.layers`` (an ``nn.ModuleList``),
where the reference scans a stacked tree; the per-layer attention kind
(local or global) is ``cfg.is_global_layer(i)``.  Prefill attention runs on
K5 (see :func:`repro_torch.nn.layers.attention_core` and, for MLA,
:func:`repro_torch.nn.layers.mla_prefill`); an MLA model's cache is the
compressed one, ``ckv`` and ``krope``.  The MoE layer runs
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
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "attn": (L.mla_template(cfg) if cfg.use_mla
                 else L.attention_template(cfg)),
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


def _layer(x, lp, cfg: ModelConfig, positions, i, routing=None):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        x = x + L.mla_apply(lp["attn"], cfg, h, positions)
    else:
        x = x + L.attention_apply(lp["attn"], cfg, h, positions,
                                  cfg.is_global_layer(i))
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp["ffn"], cfg, h, routing=routing)


def forward(model, cfg: ModelConfig, tokens, media=None, routing=None):
    """Teacher-forcing forward -> logits (B,S,V); positions ``arange(S)``.
    Under grad each layer runs under the config's remat policy (whose
    recomputation appends a MoE layer's routing to ``routing`` again)."""
    del media
    positions = C.positions(tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    layer = C.remat(_layer, cfg)
    for i, lp in enumerate(model.layers):
        x = layer(x, lp, cfg, positions, i, routing)
    return C.unembed(model.embed, cfg, x)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches in the reference's layout: K/V (L, B, T, K, D), or for
    MLA the compressed ``ckv`` (L, B, T, kv_lora_rank) and ``krope`` (L, B,
    T, qk_rope_dim)."""
    if cfg.use_mla:
        lead = (cfg.n_layers, batch, max_seq)
        return {"ckv": torch.zeros((*lead, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((*lead, cfg.qk_rope_dim), dtype=dtype,
                                     device=device)}
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_logical_axes(cfg: ModelConfig):
    if cfg.use_mla:
        return {
            "ckv": ("layers", "batch", "cache_seq", None),
            "krope": ("layers", "batch", "cache_seq", None),
        }
    return {
        "k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "cache_seq", "kv_heads", None),
    }


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
        if cfg.use_mla:
            h, _, _ = L.mla_decode(lp["attn"], cfg, h, cache["ckv"][i],
                                   cache["krope"][i], pos)
        else:
            h, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                         cache["v"][i], pos,
                                         cfg.is_global_layer(i))
        x = x + h
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(lp["ffn"], cfg, h, dropless=True)
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None,
            routing=None):
    """Full-sequence prefill -> (logits of the last position, the bf16
    cache of ``max_seq`` positions, the first S filled).  MLA's cache rows
    are the c_kv and k_rope its attention computed (the reference computes
    them a second time, to the same bits)."""
    del media
    B, S = tokens.shape
    positions = C.positions(tokens)
    cache = C.prefill_cache(sys.modules[__name__], cfg, B, max_seq or S,
                            tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.use_mla:
            out, *rows = L.mla_prefill(lp["attn"], cfg, h, positions)
            x = x + out
            names = ("ckv", "krope")
        else:
            q, k, v = L._qkv(lp["attn"], cfg, h, positions)
            out = L.attention_core(cfg, q, k, v, cfg.is_global_layer(i))
            x = x + L._out_proj(lp["attn"], out)
            rows, names = (k, v), ("k", "v")
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(lp["ffn"], cfg, h, routing=routing)
        for name, row in zip(names, rows):
            C.put_rows(cache[name], (i,), row, S)
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("dense")(sys.modules[__name__])
C.register_family("moe")(sys.modules[__name__])
