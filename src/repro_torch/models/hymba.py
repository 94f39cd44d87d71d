"""Hymba: hybrid layers with attention and Mamba heads in parallel.

Each layer computes a (sliding-window GQA) attention branch and a selective
SSM branch (:func:`repro_torch.nn.ssm.mamba_apply`) from the same input,
normalizes each and combines them with learned per-layer weights (the
paper's mean-fusion).  A few layers ({0, mid, last}) attend globally.  The
decode state is the KV cache (attention) plus the SSM state: ``h`` (f32)
and the conv tail.

The layers are a Python loop over ``model.layers``; a layer's attention
kind is the Python bool ``cfg.is_global_layer(i)``.  The prefill attention
runs on K5 (:func:`repro_torch.nn.layers.attention_core`): with the
config's window on the local layers, with none on the global ones.  The KV
cache keeps every position, as the reference's does.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import common as C
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as S
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import spec, stack_template


def layer_template(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ssm": S.mamba_template(cfg),
        "norm_attn": L.rmsnorm_template(cfg.d_model),
        "norm_ssm": L.rmsnorm_template(cfg.d_model),
        "beta": spec((2,), (None,), init="ones"),
        "ffn": L.mlp_template(cfg),
    }


def template(cfg: ModelConfig):
    return {
        "embed": C.embed_template(cfg),
        "layers": stack_template(layer_template(cfg), cfg.n_layers),
    }


def build(cfg: ModelConfig, device=None, dtype=None) -> C.Model:
    return C.Model(cfg, layer_template, dtype, device)


def _combine(lp, cfg, a, s):
    a = L.rmsnorm(lp["norm_attn"], a, cfg.norm_eps)
    s = L.rmsnorm(lp["norm_ssm"], s, cfg.norm_eps)
    b = lp.cast("beta", a.dtype)
    return 0.5 * (b[0] * a + b[1] * s)


def forward(model, cfg: ModelConfig, tokens, media=None):
    """Teacher-forcing forward -> logits (B,S,V); positions ``arange(S)``.
    Under grad each layer runs under the config's remat policy."""
    del media
    positions = C.positions(tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    layer = C.remat(_layer, cfg)
    for i, lp in enumerate(model.layers):
        x = layer(x, lp, cfg, positions, i)
    return C.unembed(model.embed, cfg, x)


def _layer(x, lp, cfg: ModelConfig, positions, i):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a = L.attention_apply(lp["attn"], cfg, h, positions,
                          cfg.is_global_layer(i))
    s, _state = S.mamba_apply(lp["ssm"], cfg, h)
    x = x + _combine(lp, cfg, a, s)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["ffn"], h)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches in the reference's layout: K/V (L, B, T, K, D) and the
    conv tail (L, B, CONV_K - 1, E) in ``dtype``, ``h`` (L, B, E, N) in
    f32."""
    Lc, E, N = cfg.n_layers, cfg.d_model, cfg.ssm_state
    kv = (Lc, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "h": torch.zeros((Lc, batch, E, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((Lc, batch, S.CONV_K - 1, E), dtype=dtype,
                            device=device),
    }


def cache_logical_axes(cfg: ModelConfig):
    return {
        "k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "cache_seq", "kv_heads", None),
        "h": ("layers", "batch", "mlp_act", None),
        "conv": ("layers", "batch", None, "embed_act"),
    }


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, media=None):
    """One-token decode. tokens: (B,1); pos: a 1-element int64 tensor on
    the cache's device or an int.  Returns (logits (B,1,V), cache), the
    cache updated in place: k/v at ``pos``, ``h`` and ``conv`` overwritten.
    Nothing reads the host, so a CUDA graph can capture the step."""
    del media
    pos = L.decode_position(pos, tokens.device)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h0, conv0 = cache["h"][i], cache["conv"][i]
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos,
                                     cfg.is_global_layer(i))
        s, (h1, conv1) = S.mamba_apply(lp["ssm"], cfg, h,
                                       state=(h0, conv0.to(h.dtype)))
        x = x + _combine(lp, cfg, a, s)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(lp["ffn"], h)
        h0.copy_(h1)
        conv0.copy_(conv1)
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None):
    """Full-sequence prefill -> (logits of the last position, the cache:
    k/v of ``max_seq`` positions in bf16, the first S filled; the SSM's
    ``h`` at the last position in f32 and its conv tail in bf16)."""
    del media
    B, Sq = tokens.shape
    positions = C.positions(tokens)
    cache = C.prefill_cache(sys.modules[__name__], cfg, B, max_seq or Sq,
                            tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions)
        a = L.attention_core(cfg, q, k, v, cfg.is_global_layer(i))
        a = L._out_proj(lp["attn"], a)
        s, (h1, conv1) = S.mamba_apply(lp["ssm"], cfg, h)
        x = x + _combine(lp, cfg, a, s)
        hh = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(lp["ffn"], hh)
        C.put_rows(cache["k"], (i,), k, Sq)
        C.put_rows(cache["v"], (i,), v, Sq)
        cache["h"][i] = h1
        cache["conv"][i] = conv1
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("hybrid")(sys.modules[__name__])
