"""Transformer layers of the LMs: norms, RoPE, attention, MLP, MoE.

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

The MoE layer (:func:`moe_apply`) is plain PyTorch, as the reference's is
XLA outside any Pallas kernel: batched matrix products over a capacity grid
of the experts, and a combine that gathers each token's K expert outputs and
sums them in slot order, so a run on the card repeats bit for bit (no
scatter-add, whose atomics add in any order).
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


def decode_position(pos, device):
    """The decode's position as a 1-element int64 tensor on ``device``: the
    reference's traced ``int32`` scalar.  A tensor is taken as it is (a
    captured decode step passes its static buffer); a Python int becomes
    one by a fill on the device, never a copy from host memory.  Not a 0-d
    tensor: indexing with one reads it on the host."""
    if torch.is_tensor(pos):
        return pos.reshape(1).long()
    return torch.full((1,), pos, dtype=torch.int64, device=device)


def attention_decode(params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                     is_global, use_rope=True):
    """One-token decode.  x: (B,1,E); cache: (B,T,K,D); pos: a 1-element
    int64 tensor (:func:`decode_position`) or an int.  Writes the token's
    k/v into the cache in place at ``pos`` (the reference returns updated
    copies), without reading ``pos`` on the host, and returns ``(out,
    cache_k, cache_v)``."""
    B = x.shape[0]
    pos = decode_position(pos, x.device)
    positions = pos.view(1, 1).expand(B, 1)
    q, k, v = _qkv(params, cfg, x, positions, use_rope)
    cache_k.index_copy_(1, pos, k.to(cache_k.dtype))
    cache_v.index_copy_(1, pos, v.to(cache_v.dtype))
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


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity-grid dispatch, dropless decode
# ---------------------------------------------------------------------------

def moe_template(cfg: ModelConfig):
    E, F_, X = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = {
        "router": spec((E, X), ("embed", None), scale=0.02),
        "wi": spec((X, E, F_), ("experts", "embed", "mlp")),
        "wg": spec((X, E, F_), ("experts", "embed", "mlp")),
        "wo": spec((X, F_, E), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts > 0:
        t["shared"] = mlp_template(cfg, d_ff=cfg.d_ff * cfg.n_shared_experts)
    return t


class Routing(NamedTuple):
    """One :func:`moe_apply` call's routing: each token's top-k experts
    ``(T, K)`` and the number of (token, slot) pairs dropped past capacity
    (a 0-d tensor on the device, read without a host sync)."""
    experts: torch.Tensor
    dropped: torch.Tensor


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """The reference's C = ceil(n·K/X·cf), clamped to [1, n]."""
    c = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(1, min(c, n_tokens))


def _top_k(probs, k: int):
    """lax.top_k: the k largest of each row, the lower index first among
    equals -> (values, indices), each (T, k)."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_i[:, :k]


def _experts(params, h, dt):
    """The SwiGLU experts on (X, rows, E) -> (X, rows, E), one batched
    product a weight; ``h`` may broadcast over X."""
    g = torch.matmul(h, params.cast("wg", dt))
    h = F.silu(g) * torch.matmul(h, params.cast("wi", dt))
    return torch.matmul(h, params.cast("wo", dt))


def _combine(ye, cell, top_p):
    """out[t] = sum over k of ye[cell[t, k]] * top_p[t, k], in slot order.
    ye: (cells, E) with a zero row where ``cell`` points for a dropped
    pair; cell, top_p: (T, K)."""
    return (ye[cell] * top_p[..., None]).sum(dim=1)


def _moe_grid(params, xt, top_p, top_i, X, groups, C):
    """Capacity-grid dispatch over ``groups`` equal runs of tokens (the
    batch rows for the reference's batch-local grid, 1 for its global
    grid): within a group the (token, slot) pairs are sorted stably by
    expert, and a pair whose rank in its expert is C or more is dropped.
    -> (out (T, E), dropped pairs, a 0-d tensor)."""
    dt, dev = xt.dtype, xt.device
    T, E = xt.shape
    K = top_i.shape[1]
    N = T // groups * K                                  # pairs a group
    flat_e = top_i.reshape(groups, N)
    order = torch.argsort(flat_e, dim=1, stable=True)    # group by expert
    e_sorted = flat_e.gather(1, order)
    counts = torch.zeros(groups, X, dtype=flat_e.dtype, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))   # integers
    starts = counts.cumsum(1) - counts
    rank = (torch.arange(N, device=dev)[None]
            - starts.gather(1, e_sorted))
    keep = rank < C
    # each pair's cell of the (X, groups, C) grid; a dropped pair points
    # past it, at a zero row
    g = torch.arange(groups, device=dev)[:, None]
    cell_sorted = torch.where(keep, (e_sorted * groups + g) * C + rank,
                              X * groups * C)
    cell = torch.empty_like(cell_sorted).scatter_(1, order, cell_sorted)
    # the pair that fills cell (x, g, c) is the group's sorted pair
    # starts[g, x] + c, if c < counts[g, x]; an empty cell reads row T,
    # a zero row
    c = torch.arange(C, device=dev)
    at = (starts[:, :, None] + c).clamp(max=N - 1).reshape(groups, X * C)
    pair = order.gather(1, at).reshape(groups, X, C)
    tok = torch.where(c < counts[:, :, None],
                      g[:, :, None] * (T // groups) + pair // K, T)
    x_pad = torch.cat([xt, xt.new_zeros(1, E)])
    xg = x_pad[tok.transpose(0, 1).reshape(X, groups * C)]
    ye = _experts(params, xg, dt).reshape(X * groups * C, E)
    ye = torch.cat([ye, ye.new_zeros(1, E)])
    out = _combine(ye, cell.reshape(T, K), top_p)
    return out, (~keep).sum()


def _moe_dropless(params, xt, top_p, top_i, X):
    """Dropless dispatch (the reference's ``ragged_dot``): every expert
    runs every token, one batched product a weight whatever the routing,
    and each token takes the rows of its K experts.  The products a pair
    needs are the ones ``ragged_dot`` computes; the other X - K rows a token
    cost X/K times the work, which the decode's few tokens afford (the
    expert weights are read once either way) and which keeps the launch
    count independent of the routing."""
    T, E = xt.shape
    ye = _experts(params, xt[None], xt.dtype).reshape(X * T, E)
    cell = top_i * T + torch.arange(T, device=xt.device)[:, None]
    return _combine(ye, cell, top_p)


def moe_apply(params, cfg: ModelConfig, x, dropless: bool = False,
              routing: list | None = None):
    """x: (B,S,E).  Top-k routing (softmax in f32, the top k
    renormalised), then one of the reference's three dispatch forms:

    * ``dropless=True`` or ``moe_impl="ragged"``: exact, no capacity
      (:func:`_moe_dropless`; the reference's decode path);
    * ``moe_impl="grid"``: one capacity grid over all B·S tokens, C =
      ceil(B·S·K/X·cf);
    * otherwise (``"grid_local"``): a grid a batch row, C = ceil(S·K/X·cf).

    Pairs past capacity are dropped (standard capacity-factor semantics).
    Shared experts, if any, are added after.  ``routing``, a list, gets one
    :class:`Routing` a call."""
    dt = x.dtype
    B, S, E = x.shape
    X, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, E)

    logits = xt @ params.cast("router", dt)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = _top_k(probs, K)
    top_p = (top_p / top_p.sum(dim=-1, keepdim=True)).to(dt)

    if dropless or cfg.moe_impl == "ragged":
        out = _moe_dropless(params, xt, top_p, top_i, X)
        dropped = None
    elif cfg.moe_impl == "grid":
        out, dropped = _moe_grid(params, xt, top_p, top_i, X, 1,
                                 _capacity(T, cfg))
    else:
        out, dropped = _moe_grid(params, xt, top_p, top_i, X, B,
                                 _capacity(S, cfg))
    out = out.reshape(B, S, E)
    if cfg.n_shared_experts > 0:
        out = out + mlp_apply(params["shared"], x)
    if routing is not None:
        if dropped is None:
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
        routing.append(Routing(top_i, dropped))
    return out
