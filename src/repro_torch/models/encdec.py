"""Whisper-large-v3 backbone: encoder-decoder transformer.

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, n_media_tokens, d_model)
(:func:`repro_torch.launch.serve.make_media`).  Encoder layers attend both
ways; decoder layers attend causally to the tokens and then cross-attend
the encoder output.  Positions are sinusoidal and absolute (the reference
replaces whisper's learned decoder table by sinusoids); no layer uses
RoPE.

The model has two stacks, ``encoder`` and ``decoder``, and an unstacked
``enc_norm`` beside ``embed``; each stack is a Python loop.  The prefill
runs K5 three ways, each through :mod:`repro_torch.nn.layers`: once an
encoder layer for its self-attention (non-causal), and twice a decoder
layer, for its self-attention (causal) and its cross-attention over the
encoder output (non-causal, T != S).  The cache holds the decoder's self
K/V and the cross K/V (``xk`` k-normed, ``xv``), computed once at the
prefill and read by every decode step, which cross-attends them with the
reference's plain softmax.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import common as C
from repro_torch.nn import layers as L
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import stack_template


def enc_layer_template(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "attn": L.attention_template(cfg),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "ffn": L.mlp_template(cfg, gated=False),
    }


def dec_layer_template(cfg: ModelConfig):
    return {
        "ln1": L.rmsnorm_template(cfg.d_model),
        "attn": L.attention_template(cfg),
        "lnx": L.rmsnorm_template(cfg.d_model),
        "xattn": L.cross_attention_template(cfg),
        "ln2": L.rmsnorm_template(cfg.d_model),
        "ffn": L.mlp_template(cfg, gated=False),
    }


def template(cfg: ModelConfig):
    return {
        "embed": C.embed_template(cfg),
        "enc_norm": L.rmsnorm_template(cfg.d_model),
        "encoder": stack_template(enc_layer_template(cfg),
                                  cfg.n_encoder_layers),
        "decoder": stack_template(dec_layer_template(cfg), cfg.n_layers),
    }


def build(cfg: ModelConfig, device=None, dtype=None) -> C.Model:
    return C.Model(cfg, dtype=dtype, device=device,
                   nodes={"enc_norm": L.rmsnorm_template(cfg.d_model)},
                   stacks={"encoder": (enc_layer_template(cfg),
                                       cfg.n_encoder_layers),
                           "decoder": (dec_layer_template(cfg),
                                       cfg.n_layers)})


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(model, cfg: ModelConfig, media, trace=None):
    """media: (B, M, E) precomputed frame embeddings (frontend stub) ->
    the normed encoder output (B, M, E) in the compute type.  ``trace``, a
    list, gets each encoder layer's output."""
    B, M, E = media.shape
    dt = cfg.cdtype()
    pos = L.sinusoidal_pos(_arange(M, media.device), E)
    x = media.to(dt) + pos[None].to(dt)
    layer = C.remat(_enc_layer, cfg)
    for lp in model.encoder:
        x = layer(x, lp, cfg)
        if trace is not None:
            trace.append(x)
    return L.rmsnorm(model.enc_norm, x, cfg.norm_eps)


def _enc_layer(x, lp, cfg: ModelConfig):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.bidirectional_attention_apply(lp["attn"], cfg, h)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["ffn"], h)


def _dec_layer(x, lp, cfg: ModelConfig, positions, enc_out):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + L.attention_apply(lp["attn"], cfg, h, positions, True,
                              use_rope=False)
    h = L.rmsnorm(lp["lnx"], x, cfg.norm_eps)
    x = x + L.cross_attention_apply(lp["xattn"], cfg, h, enc_out)
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["ffn"], h)


def _embed(model, cfg, tokens, pos):
    """The decoder's input: token embeddings plus the sinusoids of ``pos``
    (S,)."""
    x = C.embed_tokens(model.embed, cfg, tokens)
    return x + L.sinusoidal_pos(pos, cfg.d_model)[None].to(x.dtype)


def forward(model, cfg: ModelConfig, tokens, media=None):
    """Teacher-forcing: media (B,M,E) + decoder tokens (B,S) -> logits
    (B,S,V); positions ``arange(S)``.  Under grad each encoder and decoder
    layer runs under the config's remat policy."""
    if media is None:
        raise ValueError("the enc-dec forward needs media embeddings")
    B, S = tokens.shape
    pos = _arange(S, tokens.device)
    positions = pos.expand(B, S)
    enc_out = encode(model, cfg, media)
    x = _embed(model, cfg, tokens, pos)
    layer = C.remat(_dec_layer, cfg)
    for lp in model.decoder:
        x = layer(x, lp, cfg, positions, enc_out)
    return C.unembed(model.embed, cfg, x)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero caches in the reference's layout: the decoder's self K/V (L, B,
    T, K, D) and the cross K/V ``xk``/``xv`` (L, B, M, K, D), M the media
    length."""
    Lc, K, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shapes = {"k": max_seq, "v": max_seq, "xk": cfg.n_media_tokens,
              "xv": cfg.n_media_tokens}
    return {name: torch.zeros((Lc, batch, T, K, D), dtype=dtype,
                              device=device)
            for name, T in shapes.items()}


def cache_logical_axes(cfg: ModelConfig):
    return {
        "k": ("layers", "batch", "cache_seq", "kv_heads", None),
        "v": ("layers", "batch", "cache_seq", "kv_heads", None),
        "xk": ("layers", "batch", None, "kv_heads", None),
        "xv": ("layers", "batch", None, "kv_heads", None),
    }


def encode_to_cache(model, cfg: ModelConfig, media, cache):
    """Fill the cross-KV slots of ``cache`` from media embeddings, in
    place -> the cache."""
    enc_out = encode(model, cfg, media)
    for i, lp in enumerate(model.decoder):
        cache["xk"][i], cache["xv"][i] = L.cross_attention_kv(
            lp["xattn"], cfg, enc_out)
    return cache


def decode_step(model, cfg: ModelConfig, cache, tokens, pos, media=None):
    """One decoder token. tokens: (B,1); pos: a 1-element int64 tensor on
    the cache's device or an int.  Self-attends the K/V cache, written in
    place at ``pos``, and cross-attends the cached ``xk``/``xv``.  Returns
    (logits (B,1,V), cache); nothing reads the host, so a CUDA graph can
    capture the step."""
    del media
    pos = L.decode_position(pos, tokens.device)
    x = _embed(model, cfg, tokens, pos)
    for i, lp in enumerate(model.decoder):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = L.attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                     cache["v"][i], pos, True,
                                     use_rope=False)
        x = x + a
        h = L.rmsnorm(lp["lnx"], x, cfg.norm_eps)
        x = x + L.cross_attention_cached(lp["xattn"], cfg, h,
                                         cache["xk"][i].to(h.dtype),
                                         cache["xv"][i].to(h.dtype))
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(lp["ffn"], h)
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None):
    """Encoder and decoder prefill -> (logits of the last position, the
    bf16 cache: k/v of ``max_seq`` positions, the first S filled, and the
    cross K/V of every decoder layer).  A layer's cross K/V are computed
    once and feed both its K5 call and the cache (the reference computes
    them twice, to the same bits)."""
    if media is None:
        raise ValueError("the enc-dec prefill needs media embeddings")
    B, S = tokens.shape
    pos = _arange(S, tokens.device)
    positions = pos.expand(B, S)
    cache = C.prefill_cache(sys.modules[__name__], cfg, B, max_seq or S,
                            tokens)
    enc_out = encode(model, cfg, media)
    x = _embed(model, cfg, tokens, pos)
    for i, lp in enumerate(model.decoder):
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions, use_rope=False)
        x = x + L._out_proj(lp["attn"], L.attention_core(cfg, q, k, v, True))
        h = L.rmsnorm(lp["lnx"], x, cfg.norm_eps)
        kv = L.cross_attention_kv(lp["xattn"], cfg, enc_out)
        x = x + L.cross_attention_apply(lp["xattn"], cfg, h, enc_out, kv=kv)
        h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(lp["ffn"], h)
        C.put_rows(cache["k"], (i,), k, S)
        C.put_rows(cache["v"], (i,), v, S)
        cache["xk"][i], cache["xv"][i] = kv
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("encdec")(sys.modules[__name__])
