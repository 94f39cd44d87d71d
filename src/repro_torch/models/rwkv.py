"""RWKV6 (Finch) — attention-free LM with data-dependent decay.

Decode state is O(1) per layer: (WKV state (B,H,D,D), time-mix shift token,
channel-mix shift token).  The layers are a Python loop over
``model.layers``; the prefill's WKV recurrence runs on K6 (see
:func:`repro_torch.nn.ssm.rwkv6_apply`), which also returns the state the
decode starts from.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import common as C
from repro_torch.nn import ssm as S
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import rmsnorm, rmsnorm_template
from repro_torch.nn.param import stack_template


def layer_template(cfg: ModelConfig):
    return {
        "ln1": rmsnorm_template(cfg.d_model),
        "ln2": rmsnorm_template(cfg.d_model),
        "tmix": S.rwkv6_template(cfg),
        "cmix": S.rwkv6_channel_template(cfg),
    }


def template(cfg: ModelConfig):
    return {
        "embed": C.embed_template(cfg),
        "layers": stack_template(layer_template(cfg), cfg.n_layers),
    }


def build(cfg: ModelConfig, device=None, dtype=None) -> C.Model:
    return C.Model(cfg, layer_template, dtype, device)


def forward(model, cfg: ModelConfig, tokens, media=None):
    del media
    x = C.embed_tokens(model.embed, cfg, tokens)
    for lp in model.layers:
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h, _s, _last = S.rwkv6_apply(lp["tmix"], cfg, h, chunked=True)
        x = x + h
        h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        h, _last2 = S.rwkv6_channel_apply(lp["cmix"], cfg, h)
        x = x + h
    return C.unembed(model.embed, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None):
    """O(1) state; max_seq only sets decode-loop bounds, not memory."""
    E = cfg.d_model
    H, D = S.heads(cfg)
    Lc = cfg.n_layers
    return {
        "wkv": torch.zeros((Lc, batch, H, D, D), dtype=torch.float32,
                           device=device),
        "tm_last": torch.zeros((Lc, batch, 1, E), dtype=dtype, device=device),
        "cm_last": torch.zeros((Lc, batch, 1, E), dtype=dtype, device=device),
    }


def decode_step(model, cfg: ModelConfig, cache, tokens, pos=None,
                media=None):
    """One-token decode; the state is updated in place (so a warm-up step
    runs on a clone of the cache, never on the one being served).  ``pos``
    is unused: the state carries the position.  Nothing reads the host, so
    a CUDA graph can capture the step."""
    del pos, media
    x = C.embed_tokens(model.embed, cfg, tokens)  # (B,1,E)
    for i, lp in enumerate(model.layers):
        tm_last, cm_last = cache["tm_last"][i], cache["cm_last"][i]
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h_out, wkv_new, tm_new = S.rwkv6_apply(
            lp["tmix"], cfg, h, chunked=False,
            state=(cache["wkv"][i], tm_last.to(h.dtype)))
        x = x + h_out
        h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        h_out, cm_new = S.rwkv6_channel_apply(lp["cmix"], cfg, h,
                                              cm_last.to(h.dtype))
        x = x + h_out
        cache["wkv"][i] = wkv_new
        tm_last.copy_(tm_new)
        cm_last.copy_(cm_new)
    return C.unembed(model.embed, cfg, x), cache


def prefill(model, cfg: ModelConfig, tokens, max_seq=None, media=None):
    """Chunked full-sequence pass that also returns the recurrent state."""
    del max_seq, media
    B = tokens.shape[0]
    cache = init_cache(cfg, B, 0, device=tokens.device)
    x = C.embed_tokens(model.embed, cfg, tokens)
    for i, lp in enumerate(model.layers):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h_out, wkv, tm = S.rwkv6_apply(lp["tmix"], cfg, h, chunked=True)
        x = x + h_out
        h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        h_out, cm = S.rwkv6_channel_apply(lp["cmix"], cfg, h)
        x = x + h_out
        cache["wkv"][i] = wkv
        cache["tm_last"][i] = tm
        cache["cm_last"][i] = cm
    logits = C.unembed(model.embed, cfg, x[:, -1:])
    return logits, cache


C.register_family("ssm")(sys.modules[__name__])
