"""Llama-3.2-Vision-90B backbone: a decoder LM with gated cross-attention
layers over (stubbed) vision patch embeddings.

100 layers are 20 groups of 4 self-attention layers and 1 cross-attention
layer.  The vision tower is a stub, as in the reference: the caller gives
precomputed patch embeddings (B, n_media_tokens, d_model)
(:func:`repro_torch.launch.serve.make_media`).  A cross layer's attention
and MLP outputs are scaled by ``tanh`` of a learned 0-d gate; the gates
start at 0 (the reference's init, as Llama 3.2's), so a new model's cross
layers are the identity.

The model has one stack, ``groups``, whose layers hold a stack of their
own: ``model.groups[g].self[j]`` is self layer ``j`` of group ``g`` and
``model.groups[g].cross`` its cross layer (the reference stacks them on
(group, layer) and on group).  Each group is a Python loop over its self
layers and then its cross layer.  The prefill runs K5 two ways, each
through :mod:`repro_torch.nn.layers`: causal with no window at each self
layer, and non-causal from the S tokens to the M media tokens at each
cross layer.  The cache holds the self layers' K/V, (G, 4, B, T, K, D),
and each group's media K/V, ``xk`` (k-normed) and ``xv``, (G, B, M, K,
D), which every decode step reads.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import common as C
from repro_torch.nn import layers as L
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import spec, stack_template

GROUP = 5  # 4 self + 1 cross per group


def self_layer_template(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "ffn": L.mlp_template(cfg),
    }


def cross_layer_template(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "xattn": L.cross_attention_template(cfg),
        "gate_attn": spec((), (), init="zeros"),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "ffn": L.mlp_template(cfg),
        "gate_ffn": spec((), (), init="zeros"),
    }


def template(cfg: ModelConfig):
    group = {
        "self": stack_template(self_layer_template(cfg), GROUP - 1),
        "cross": cross_layer_template(cfg),
    }
    return {
        "embed": C.embed_template(cfg),
        "groups": stack_template(group, cfg.n_layers // GROUP,
                                 axis_name="groups"),
    }


def build(cfg: ModelConfig, device=None, dtype=None) -> C.Model:
    group = C.Layout(nodes={"cross": cross_layer_template(cfg)},
                     stacks={"self": (self_layer_template(cfg), GROUP - 1)})
    return C.Model(cfg, dtype=dtype, device=device,
                   stacks={"groups": (group, cfg.n_layers // GROUP)})


def _gated(gate, x):
    """``tanh(gate) * x``, the 0-d gate read on the device in x's type."""
    return torch.tanh(gate.to(x.dtype)) * x


def _cross_layer(lp, cfg, x, attend):
    """A cross layer: ``attend(xattn, h)`` the attention of its normed
    input, then the MLP, each added through its gate."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + _gated(lp["gate_attn"], attend(lp["xattn"], h))
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _gated(lp["gate_ffn"], L.mlp_apply(lp["ffn"], h))


def forward(model, cfg: ModelConfig, tokens, media=None):
    """Teacher-forcing: tokens (B,S) and media (B,M,E) -> logits (B,S,V);
    positions ``arange(S)``.  Under grad each group, and each self layer
    in it, runs under the config's remat policy (the reference's nested
    scans)."""
    if media is None:
        raise ValueError("the VLM forward needs media (patch embeddings)")
    positions = C.positions(tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    media = media.to(x.dtype)
    group = C.remat(_group, cfg)
    for gp in model.groups:
        x = group(x, gp, cfg, positions, media)
    return C.unembed(model.embed, cfg, x)


def _self_layer(x, lp, cfg: ModelConfig, positions):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_apply(lp["attn"], cfg, h, positions, True)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["ffn"], h)


def _group(x, gp, cfg: ModelConfig, positions, media):
    """A group's self layers, each under remat as the reference scans
    them, then its cross layer."""
    layer = C.remat(_self_layer, cfg)
    for lp in gp.self:
        x = layer(x, lp, cfg, positions)
    return _cross_layer(gp.cross, cfg, x, lambda p, h: (
        L.cross_attention_apply(p, cfg, h, media)))


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches in the reference's layout: the self layers' K/V (G,
    GROUP - 1, B, T, K, D) and each group's media K/V ``xk``/``xv`` (G, B,
    M, K, D)."""
    G, M = cfg.n_layers // GROUP, cfg.n_media_tokens
    K, D = cfg.n_kv_heads, cfg.head_dim
    shapes = {"k": (G, GROUP - 1, batch, max_seq, K, D),
              "v": (G, GROUP - 1, batch, max_seq, K, D),
              "xk": (G, batch, M, K, D), "xv": (G, batch, M, K, D)}
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in shapes.items()}


def cache_logical_axes(cfg: ModelConfig):
    return {
        "k": ("groups", "layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("groups", "layers", "batch", "cache_seq", "kv_heads", None),
        "xk": ("groups", "batch", None, "kv_heads", None),
        "xv": ("groups", "batch", None, "kv_heads", None),
    }


def cache_batch(cache) -> int:
    """The batch of a cache: axis 1 of ``xk`` (axis 1 of ``k`` is the
    group's self layer)."""
    return cache["xk"].shape[1]


def encode_to_cache(model, cfg: ModelConfig, media, cache):
    """Fill each group's media K/V slots from patch embeddings, in place ->
    the cache.  The K/V are projected in the media's own type (f32 from the
    stub frontend) and rounded into the cache's, as the reference does;
    the prefill projects them in the compute type."""
    for g, gp in enumerate(model.groups):
        cache["xk"][g], cache["xv"][g] = L.cross_attention_kv(
            gp.cross["xattn"], cfg, media)
    return cache


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, media=None):
    """One-token decode. tokens: (B,1); pos: a 1-element int64 tensor on
    the cache's device or an int.  Each self layer attends its K/V cache,
    written in place at ``pos``; each cross layer attends its group's
    cached ``xk``/``xv``.  Returns (logits (B,1,V), cache); nothing reads
    the host, so a CUDA graph can capture the step.  ``media`` is not
    read: the cache holds its K/V."""
    del media
    pos = L.decode_position(pos, tokens.device)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for g, gp in enumerate(model.groups):
        for j, lp in enumerate(gp.self):
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            a, _, _ = L.attention_decode(lp["attn"], cfg, h,
                                         cache["k"][g, j], cache["v"][g, j],
                                         pos, True)
            x = x + a
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_apply(lp["ffn"], h)
        xk, xv = cache["xk"][g].to(x.dtype), cache["xv"][g].to(x.dtype)
        x = _cross_layer(gp.cross, cfg, x, lambda p, h: (
            L.cross_attention_cached(p, cfg, h, xk, xv)))
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None):
    """Full-sequence prefill -> (logits of the last position, the bf16
    cache: the self layers' k/v of ``max_seq`` positions, the first S
    filled, and each group's media K/V in the compute type's projection).
    A group's media K/V are computed once and feed both its K5 call and
    the cache (the reference computes them twice, to the same bits)."""
    if media is None:
        raise ValueError("the VLM prefill needs media (patch embeddings)")
    B, S = tokens.shape
    positions = C.positions(tokens)
    cache = C.prefill_cache(sys.modules[__name__], cfg, B, max_seq or S,
                            tokens)
    x = C.embed_tokens(model.embed, cfg, tokens)
    media = media.to(x.dtype)
    for g, gp in enumerate(model.groups):
        for j, lp in enumerate(gp.self):
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = L._qkv(lp["attn"], cfg, h, positions)
            x = x + L._out_proj(lp["attn"],
                                L.attention_core(cfg, q, k, v, True))
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp_apply(lp["ffn"], h)
            C.put_rows(cache["k"], (g, j), k, S)
            C.put_rows(cache["v"], (g, j), v, S)
        kv = L.cross_attention_kv(gp.cross["xattn"], cfg, media)
        x = _cross_layer(gp.cross, cfg, x, lambda p, h: (
            L.cross_attention_apply(p, cfg, h, None, kv=kv)))
        cache["xk"][g], cache["xv"][g] = kv
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("vlm")(sys.modules[__name__])
