"""Transformer layers of the dense LMs: norms, RoPE, attention, MLP.

Pure-function style, as in the reference: ``*_template(cfg)`` returns a
ParamSpec tree; ``*_apply(params, x, ...)`` computes, with ``params`` a
:class:`repro_torch.nn.param.Params` node.  The
reference's sharding annotations (``constrain``, ``weight_gather``) are
identities outside a mesh and are left out.  Weights are cast to the
compute type once (:meth:`Params.cast`), where the reference casts them at
every use to the same bits.

Full-sequence self-attention (train / prefill, positions ``arange(S)``) goes
through K5 (:mod:`repro_torch.kernels.flash_attention`): the kernel on CUDA
tensors, its plain version on CPU tensors.  The one-token decode keeps the
reference's plain masked softmax over the cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as _k5
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import spec

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_template(dim: int):
    return {"scale": spec((dim,), (None,), init="ones")}


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta=10_000.0):
    """x: (..., S, H, D) rotated pairwise; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].float() * freqs[None, :]  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[..., :, None, :]  # broadcast over heads
    sin = sin[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (MHA / GQA, causal / sliding-window)
# ---------------------------------------------------------------------------

def attention_template(cfg: ModelConfig):
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": spec((E, H, D), ("embed", "heads", None)),
        "wk": spec((E, K, D), ("embed", "kv_heads", None)),
        "wv": spec((E, K, D), ("embed", "kv_heads", None)),
        "wo": spec((H, D, E), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = spec((H, D), ("heads", None), init="zeros")
        t["bk"] = spec((K, D), ("kv_heads", None), init="zeros")
        t["bv"] = spec((K, D), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = rmsnorm_template(D)
        t["k_norm"] = rmsnorm_template(D)
    return t


def _proj(x, w):
    """einsum("bse,e...->bs...", x, w) as one matrix product."""
    E = w.shape[0]
    return (x @ w.reshape(E, -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _qkv(params, cfg, x, positions, use_rope=True):
    dt = x.dtype
    q = _proj(x, params.cast("wq", dt))
    k = _proj(x, params.cast("wk", dt))
    v = _proj(x, params.cast("wv", dt))
    if cfg.qkv_bias:
        q = q + params.cast("bq", dt)
        k = k + params.cast("bk", dt)
        v = v + params.cast("bv", dt)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(params, out):
    """einsum("bshd,hde->bse", out, wo)."""
    wo = params.cast("wo", out.dtype)
    H, D, E = wo.shape
    return out.reshape(*out.shape[:-2], H * D) @ wo.reshape(H * D, E)


def _gqa_scores_softmax_out(cfg, q, k, v, mask):
    """q: (B,S,H,D), k/v: (B,T,K,D), mask: (B,1,1,S,T) or (1,1,1,S,T)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


def attention_core(cfg, q, k, v, is_global: bool):
    """Causal self-attention over a full sequence whose positions are
    ``arange(S)`` (train / prefill): K5 on CUDA, its plain version on the
    CPU.  q: (B,S,H,D), k/v: (B,S,K,D) -> (B,S,H,D).  Global layers take
    no window, which is the reference mask ``causal & (within |
    is_global)``."""
    window = 0 if is_global else cfg.window
    return _k5.flash_attention(q, k, v, causal=True, window=window)


def causal_window_mask(positions_q, positions_k, window: int, is_global):
    """(..., S, T) bool mask; is_global a per-layer bool."""
    dq = positions_q[..., :, None]
    dk = positions_k[..., None, :]
    causal = dk <= dq
    if window <= 0:
        return causal
    within = (dq - dk) < window
    return causal & (within | bool(is_global))


def attention_apply(params, cfg: ModelConfig, x, positions, is_global,
                    use_rope=True):
    """Self-attention over a full sequence (train / prefill); positions are
    ``arange(S)`` (they feed RoPE; the mask is K5's positional one)."""
    q, k, v = _qkv(params, cfg, x, positions, use_rope)
    out = attention_core(cfg, q, k, v, is_global)
    return _out_proj(params, out)


def attention_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     is_global, use_rope=True):
    """One-token decode.  x: (B,1,E); cache: (B,T,K,D); pos: int index.
    Writes the token's k/v into the cache in place (the reference returns
    updated copies) and returns ``(out, cache_k, cache_v)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions, use_rope)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    T = cache_k.shape[1]
    pk = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    mask = causal_window_mask(positions, pk, cfg.window, is_global)
    mask = mask[:, None, None, :, :]
    out = _gqa_scores_softmax_out(cfg, q, cache_k.to(q.dtype),
                                  cache_v.to(q.dtype), mask)
    return _out_proj(params, out), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_template(cfg: ModelConfig, d_ff=None, gated=True):
    E, F_ = cfg.d_model, d_ff or cfg.d_ff
    t = {
        "wi": spec((E, F_), ("embed", "mlp")),
        "wo": spec((F_, E), ("mlp", "embed")),
    }
    if gated:
        t["wg"] = spec((E, F_), ("embed", "mlp"))
    return t


def mlp_apply(params, x):
    dt = x.dtype
    h = x @ params.cast("wi", dt)
    if "wg" in params:
        g = x @ params.cast("wg", dt)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ params.cast("wo", dt)
