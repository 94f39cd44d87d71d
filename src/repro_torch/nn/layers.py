"""Transformer layers of the LMs and of the enc-dec family: norms, RoPE and
sinusoidal positions, attention (MHA / GQA, deepseek-v2's MLA, whisper's
bidirectional encoder attention and cross-attention), MLP, MoE.

Pure-function style, as in the reference: ``*_template(cfg)`` returns a
ParamSpec tree; ``*_apply(params, x, ...)`` computes, with ``params`` a
:class:`repro_torch.nn.param.Params` node.  Activations and weights carry
the reference's sharding annotations at its places
(:func:`~repro_torch.distributed.sharding.constrain`,
:func:`~repro_torch.distributed.sharding.weight_gather`): identities outside
:func:`~repro_torch.distributed.sharding.use_mesh_rules`, redistributions of
DTensors inside it.  Weights are cast to the compute type once
(:meth:`Params.cast`), where the reference casts them at every use to the
same bits.

Full-sequence self-attention (train / prefill, positions ``arange(S)``) goes
through K5 (:mod:`repro_torch.kernels.flash_attention`): the kernel on CUDA
tensors, its plain version on CPU tensors.  The one-token decode keeps the
reference's plain masked softmax over the cache; under a mesh whose rules
split the cache's positions over ranks it is the reference's flash-decode
(:func:`gqa_decode_block`, :func:`mla_decode_block`): each rank's own
positions, combined by all-reduces of the softmax's max and sum and of the
output.  MLA's prefill attention
is K5 too, on 192-wide q/k heads and 128-wide v heads (deepseek-v2); its
decode keeps the reference's absorbed query over the compressed cache.
The enc-dec family's encoder self-attention and its cross-attention over
the encoder output are K5 without the causal mask (T != S for the
cross-attention); the decode cross-attends the cached K/V with the
reference's plain softmax.  Every K5 call goes through :func:`_flash`,
which under a mesh hands the kernel each rank's local shards (a kernel
reads ``data_ptr()``; no DTensor reaches it), q's heads paired with the KV
heads they read under the global GQA ratio.

The MoE layer (:func:`moe_apply`) is plain PyTorch, as the reference's is
XLA outside any Pallas kernel: batched matrix products over a capacity grid
of the experts, and a combine that gathers each token's K expert outputs and
sums them in slot order, so a run on the card repeats bit for bit (no
scatter-add, whose atomics add in any order).  Its grids take the
reference's layouts and constraints; under a mesh the routing's integer
bookkeeping and the gathers by index run on each rank's local shards.

``cfg.attention_impl`` picks the full-sequence attention: ``"chunked"``
(the default) is K5, ``"dense"`` the reference's dense scores and softmax
(the dry run's "baseline" profile).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.distributed.sharding import (active_mesh, constrain,
                                              is_distributed, mesh_placements,
                                              redistribute, reshape,
                                              run_local, shard_block,
                                              weight_gather)
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


def sinusoidal_pos(positions, dim):
    """Absolute sinusoidal embeddings (..., dim) in f32 of integer
    ``positions`` (...,), a tensor on any device (the decode passes its
    (1,) position buffer, so nothing is read on the host)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    """einsum("bse,e...->bs...", x, w) as one matrix product (under a mesh
    through :func:`~repro_torch.distributed.sharding.reshape`, which
    gathers a shard DTensor could not carry through the reshapes)."""
    E = w.shape[0]
    y = x @ reshape(w, (E, -1))
    return reshape(y, (*x.shape[:-1], *w.shape[1:]))


def _flat_mm(x, w):
    """x (..., E) @ w (E, n) as one product of x flattened to (tokens, E),
    the flattening through :func:`~repro_torch.distributed.sharding.
    reshape`, whose backward gathers a gradient's shard that it cannot carry
    (a gradient sharded over the sequence)."""
    y = reshape(x, (-1, x.shape[-1])) @ w
    return reshape(y, (*x.shape[:-1], w.shape[1]))


def _qkv(params, cfg, x, positions, use_rope=True):
    dt = x.dtype
    q = _proj(x, weight_gather(params.cast("wq", dt), ("embed", "heads", None)))
    k = _proj(x, weight_gather(params.cast("wk", dt),
                               ("embed", "kv_heads", None)))
    v = _proj(x, weight_gather(params.cast("wv", dt),
                               ("embed", "kv_heads", None)))
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
    q = constrain(q, ("batch", "seq", "heads_act", None))
    k = constrain(k, ("batch", "seq", None, None))
    return q, k, v


def _out_proj(params, out, gather: bool = False):
    """einsum("bshd,hde->bse", out, wo); ``gather``: wo through
    :func:`weight_gather`, as the reference's self-attention reads it."""
    wo = params.cast("wo", out.dtype)
    if gather:
        wo = weight_gather(wo, ("heads", None, "embed"))
    H, D, E = wo.shape
    return (reshape(out, (*out.shape[:-2], H * D))
            @ reshape(wo, (H * D, E)))


def _gqa_scores_softmax_out(cfg, q, k, v, mask):
    """q: (B,S,H,D), k/v: (B,T,K,D), mask: (B,1,1,S,T) or (1,1,1,S,T), or
    None for every key (the reference's all-true mask).  Under a mesh on
    each rank's q heads against their KV heads, as K5 (:func:`_by_heads`),
    every key position on every rank: the dense full-sequence attention and
    the cross-attention, whose keys no rule splits by position.  The decode
    over a cache whose positions the ranks split is flash-decode instead
    (:func:`_decode_attention`)."""
    if is_distributed(q, k, v):
        extra = () if mask is None else ((mask, (
            "batch" if mask.shape[0] == q.shape[0] else None,
            None, None, None, None)),)
        return _by_heads(lambda ql, kl, vl, *m: _gqa_scores_softmax_out(
            cfg, ql, kl, vl, m[0] if m else None), q, k, v, extra)
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


#: the logical axes K5's operands take under a mesh: q's heads sharded as
#: the reference constrains them, k's and v's replicated (``_qkv``)
_Q_AXES = ("batch", "seq", "heads_act", None)
_KV_AXES = ("batch", "seq", None, None)


def _kv_block(H: int, Hk: int, idx: int, n: int) -> tuple[int, int]:
    """The KV heads ``[a, b)`` that q's head block ``idx`` of ``n`` reads
    under the global GQA ratio ``g = H / Hk`` (q head h reads KV head
    h // g): the block's whole groups, or the one KV head a block inside a
    group shares.  A block that cuts a group unevenly is refused."""
    g, hl = H // Hk, H // n
    if hl % g == 0:
        a = idx * hl // g
        return a, a + hl // g
    if g % hl == 0:
        a = idx * hl // g
        return a, a + 1
    raise ValueError(f"{n} blocks of {H} q heads break the GQA ratio "
                     f"{H}/{Hk}: a block of {hl} heads straddles a group of "
                     f"{g}")


def _by_heads(fn, q, k, v, extra=()):
    """``fn(q, k, v, *extra)`` on each rank's local shards: q with its heads
    sharded by the rules, k and v with their heads replicated and cut here
    to the KV heads the local q heads read (:func:`_kv_block`), ``extra``
    more ``(tensor, logical axes)`` inputs; the output (B, S, H, DV) is
    sharded as q.  Differentiable (:func:`run_local`)."""
    B, S, H, _ = q.shape
    Hk = k.shape[2]

    def local(ql, kl, vl, *rest):
        *xs, pls = rest
        idx, n = shard_block(active_mesh(), pls[0], 2)
        a, b = _kv_block(H, Hk, idx, n)
        if (a, b) != (0, Hk):
            kl, vl = kl[:, :, a:b], vl[:, :, a:b]
        return fn(ql, kl, vl, *xs)

    return run_local(local, [(q, _Q_AXES), (k, _KV_AXES), (v, _KV_AXES),
                             *extra],
                     [(_Q_AXES, (B, S, H, v.shape[3]))])


def _flash(q, k, v, *, causal: bool, window: int = 0):
    """Every K5 call.  Plain tensors go to the kernel as they are.  Under a
    mesh (DTensors) the kernel runs on each rank's local shards
    (:func:`_by_heads`).  The boundary is differentiable, so K5's backward
    kernel runs on the shards too."""
    def k5(ql, kl, vl):
        return _k5.flash_attention(ql, kl, vl, causal=causal, window=window)
    if not is_distributed(q, k, v):
        return k5(q, k, v)
    return _by_heads(k5, q, k, v)


def _dense(cfg) -> bool:
    """Does the config ask for the reference's dense attention
    (``attention_impl="dense"``, the dry run's "baseline" profile)?  The
    default, ``"chunked"``, is K5."""
    if cfg.attention_impl not in ("chunked", "dense"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    return cfg.attention_impl == "dense"


def attention_core(cfg, q, k, v, is_global: bool):
    """Causal self-attention over a full sequence whose positions are
    ``arange(S)`` (train / prefill): K5 on CUDA, its plain version on the
    CPU.  q: (B,S,H,D), k/v: (B,S,K,D) -> (B,S,H,D).  Global layers take
    no window, which is the reference mask ``causal & (within |
    is_global)``.  ``attention_impl="dense"``: the reference's dense
    attention instead, the scores and the softmax whole and its
    probabilities rounded to the compute type."""
    if _dense(cfg):
        pos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
        mask = causal_window_mask(pos[None], pos[None], cfg.window, is_global)
        return _gqa_scores_softmax_out(cfg, q, k, v, mask[:, None, None])
    window = 0 if is_global else cfg.window
    return _flash(q, k, v, causal=True, window=window)


def bidirectional_attention_apply(params, cfg: ModelConfig, x):
    """The enc-dec encoder's self-attention over a full sequence: every
    query sees every key (the reference's all-ones mask), no RoPE.  K5
    with ``causal=False``, no window."""
    q, k, v = _qkv(params, cfg, x, None, use_rope=False)
    out = _flash(q, k, v, causal=False, window=0)
    return constrain(_out_proj(params, out, gather=True),
                     ("batch", "seq", "embed_act"))


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
    return constrain(_out_proj(params, out, gather=True),
                     ("batch", "seq", "embed_act"))


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
    cache_write(cache_k, pos, k)
    cache_write(cache_v, pos, v)
    ck = constrain(cache_k, _CACHE_AXES)
    cv = constrain(cache_v, _CACHE_AXES)
    out = _decode_attention(cfg, q, ck.to(q.dtype), cv.to(q.dtype), pos,
                            is_global)
    return _out_proj(params, out, gather=True), cache_k, cache_v


def _decode_attention(cfg, q, ck, cv, pos, is_global):
    """The one-token attention of q (B,1,H,D) over the cache ck/cv
    (B,T,K,D) at position ``pos`` (1-element tensor), masked causally and
    by the layer's window.  A cache whose positions the ranks split
    (:func:`positions_split`) runs flash-decode (:func:`_flash_decode`);
    otherwise the reference's softmax over every position
    (:func:`_gqa_scores_softmax_out`)."""
    if positions_split(ck):
        return _flash_decode(q, ck, cv, pos, cfg.window, is_global)
    B, T = q.shape[0], ck.shape[1]
    positions = pos.view(1, 1).expand(B, 1)
    pk = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    mask = causal_window_mask(positions, pk, cfg.window, is_global)
    return _gqa_scores_softmax_out(cfg, q, ck, cv, mask[:, None, None, :, :])


def cache_write(cache, pos, row):
    """``cache[:, pos] = row`` in place: cache (B, T, ...), row (B, 1, ...),
    pos a 1-element int64 tensor, never read on the host.  A DTensor cache
    sharded over T (the rules' ``cache_seq``) is written on its local
    shards: the rank that holds position ``pos`` writes the row, every other
    rank writes back what it holds."""
    if not is_distributed(cache):
        cache.index_copy_(1, pos, row.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    row_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                   for p in pl)
    local = cache.to_local()
    r = redistribute(row, mesh, row_pl).to_local().to(cache.dtype)
    idx, n = shard_block(mesh, pl, 1)
    tl = local.shape[1]
    rel = pos - idx * tl
    at = rel.clamp(0, tl - 1)
    here = ((rel >= 0) & (rel < tl)).view((1, 1) + (1,) * (r.dim() - 2))
    local.index_copy_(1, at, torch.where(here, r, local.index_select(1, at)))


# ---------------------------------------------------------------------------
# flash-decode: the one-token attention over a cache sharded by position
# ---------------------------------------------------------------------------

#: the decode cache's logical axes (the rules' ``cache_seq`` splits its
#: positions) and the one-token query's, its heads whole on every rank
_CACHE_AXES = ("batch", "cache_seq", None, None)
_DECODE_Q_AXES = ("batch", None, None, None)


def positions_split(cache) -> bool:
    """Is ``cache`` (B, T, ...) a DTensor whose T positions more than one
    rank splits (the rules' ``cache_seq``)?"""
    if not is_distributed(cache):
        return False
    return shard_block(cache.device_mesh, cache.placements, 1)[1] > 1


def decode_softmax(s, reduce):
    """The reference's softmax over key positions split into blocks: ``s``
    one block's scores (..., Tl), f32, masked by ``NEG_INF``; ``reduce(x,
    op)`` gives ``x`` reduced by ``op`` ("max" or "sum") over the blocks
    (every block gets the result: an all-reduce).  The global maximum comes
    before any exponential, so a block whose positions are all masked adds
    exp(NEG_INF - m) = 0 to the sum, never a NaN.  -> the block's weights
    e / l in f32."""
    m = reduce(s.amax(-1, keepdim=True), "max")
    e = torch.exp(s - m)
    return e / reduce(e.sum(-1, keepdim=True), "sum")


def gqa_decode_block(q, k, v, mask, reduce):
    """The GQA decode attention's local step and combine on one block of
    the cache's positions: q (B,S,H,D), k/v (B,Tl,K,D), ``mask``
    broadcastable to (B,K,G,S,Tl) (the global positions this block holds,
    causal and windowed), ``reduce`` as :func:`decode_softmax`'s.  The
    reference's order (:func:`_gqa_scores_softmax_out`): f32 scores, the softmax's
    max and sum reduced over the blocks, the weights rounded to q's type,
    then the weighted sum over the block's value rows in f32, summed over
    the blocks and rounded once.  -> (B,S,H,D) in q's type."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    w = decode_softmax(torch.where(mask, s, NEG_INF), reduce).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w.float(), v.float())
    return reduce(out, "sum").to(q.dtype).reshape(B, S, H, D)


def mla_decode_block(q_abs, q_rope, ckv, krope, mask, scale, reduce):
    """MLA's absorbed decode attention on one block of the compressed
    cache's positions: q_abs (B,S,H,kr), q_rope (B,S,H,dr), ckv (B,Tl,kr),
    krope (B,Tl,dr), ``mask`` broadcastable to (B,H,S,Tl), ``reduce`` as
    :func:`decode_softmax`'s.  The reference's order (:func:`mla_decode`):
    the two products summed in the compute type and scaled in f32, the
    softmax reduced over the blocks, the weights rounded, the block's
    weighted ckv rows in f32 summed over the blocks and rounded once.
    -> out_c (B,S,H,kr) in the compute type."""
    dt = q_abs.dtype
    s = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
         + torch.einsum("bshd,btd->bhst", q_rope, krope)).float() * scale
    w = decode_softmax(torch.where(mask, s, NEG_INF), reduce).to(dt)
    out_c = torch.einsum("bhst,btr->bshr", w.float(), ckv.float())
    return reduce(out_c, "sum").to(dt)


def _all_reduce_over(mesh, dims):
    """``reduce(x, op)`` for :func:`decode_softmax`: an all-reduce of ``x``
    over the ranks of the mesh dimensions ``dims``, one after another."""
    from torch.distributed import _functional_collectives as funcol

    def reduce(x, op):
        for d in dims:
            x = funcol.all_reduce(x, op, (mesh, d))
            if isinstance(x, funcol.AsyncCollectiveTensor):
                x = x.wait()
        return x
    return reduce


def _position_block(cache_pl, tl: int, device):
    """(the global positions of this rank's block of the cache, (Tl,)
    int32; ``reduce`` over the mesh dimensions that split them), for a
    cache of placements ``cache_pl`` whose local block holds ``tl``
    positions."""
    mesh = active_mesh()
    idx, _ = shard_block(mesh, cache_pl, 1)
    dims = [i for i, p in enumerate(cache_pl)
            if isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1]
    pk = idx * tl + torch.arange(tl, dtype=torch.int32, device=device)
    return pk, _all_reduce_over(mesh, dims)


def _flash_decode(q, ck, cv, pos, window: int, is_global):
    """Flash-decode over a cache whose positions the ranks split: each rank
    runs :func:`gqa_decode_block` on its own positions (masked by their
    global indices) and the blocks combine by all-reduces of a (B,K,G,1,1)
    max, a sum of that shape and the (B,1,H,D) f32 output, so nothing that
    moves grows with the cache.  q's heads are gathered (B,1,H,D): the
    reference constrains them over "model", which the positions also take
    under its rules, and the query is the smaller operand to move.  ->
    (B,1,H,D), its heads whole."""
    B, S, H, D = q.shape

    def local(ql, kl, vl, pls):
        pk, reduce = _position_block(pls[1], kl.shape[1], kl.device)
        mask = causal_window_mask(pos.view(1, 1), pk[None], window, is_global)
        return gqa_decode_block(ql, kl, vl, mask[:, None, None], reduce)

    return run_local(local, [(q, _DECODE_Q_AXES), (ck, _CACHE_AXES),
                             (cv, _CACHE_AXES)],
                     [(_DECODE_Q_AXES, (B, S, H, D))])


def _flash_decode_mla(q_abs, q_rope, ckv, krope, pos, scale):
    """:func:`_flash_decode` for MLA: :func:`mla_decode_block` on each
    rank's positions of ``ckv`` and ``krope`` (B,T,·), the query heads
    gathered; -> out_c (B,1,H,kr), all-reduced before ``wkv_b``'s value
    half."""
    B, S, H, kr = q_abs.shape
    axes = _CACHE_AXES[:3]

    def local(qa, qr, cl, rl, pls):
        pk, reduce = _position_block(pls[2], cl.shape[1], cl.device)
        return mla_decode_block(qa, qr, cl, rl, pk <= pos, scale, reduce)

    return run_local(local, [(q_abs, _DECODE_Q_AXES),
                             (q_rope, _DECODE_Q_AXES), (ckv, axes),
                             (krope, axes)],
                     [(_DECODE_Q_AXES, (B, S, H, kr))])


def fold_blocks(x, n: int, dim: int = 1):
    """``x``'s positions (dimension ``dim``) cut into ``n`` equal blocks
    stacked on dimension 0, block-major: what ``n`` ranks hold, side by
    side on one device (the card's check and the CPU tests of the local
    step; the query goes with them repeated, ``x.repeat(n, ...)``)."""
    return torch.cat(x.chunk(n, dim), 0)


def block_reduce(n: int):
    """``reduce(x, op)`` over ``n`` blocks stacked by :func:`fold_blocks`:
    the max or the sum over the blocks, given to each: the all-reduce of
    ``n`` ranks on one device."""
    def reduce(x, op):
        xs = x.unflatten(0, (n, -1))
        r = xs.amax(0) if op == "max" else xs.sum(0)
        return r.repeat(n, *(1,) * (r.dim() - 1))
    return reduce


# ---------------------------------------------------------------------------
# cross-attention (the enc-dec decoder over the encoder output)
# ---------------------------------------------------------------------------

def cross_attention_template(cfg: ModelConfig):
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": spec((E, H, D), ("embed", "heads", None)),
        "wk": spec((E, K, D), ("embed", "kv_heads", None)),
        "wv": spec((E, K, D), ("embed", "kv_heads", None)),
        "wo": spec((H, D, E), ("heads", None, "embed")),
        "q_norm": rmsnorm_template(D),
        "k_norm": rmsnorm_template(D),
    }


def cross_attention_kv(params, cfg: ModelConfig, media):
    """The cross-attention's keys, k-normed, and values (B,M,K,D) over
    ``media`` (B,M,E), in media's type: what the decode's cache keeps (the
    reference's ``_cross_kv``)."""
    dt = media.dtype
    k = _proj(media, params.cast("wk", dt))
    v = _proj(media, params.cast("wv", dt))
    return rmsnorm(params["k_norm"], k, cfg.norm_eps), v


def _cross_q(params, cfg, x):
    q = _proj(x, params.cast("wq", x.dtype))
    return rmsnorm(params["q_norm"], q, cfg.norm_eps)


def cross_attention_apply(params, cfg: ModelConfig, x, media, kv=None):
    """x: (B,S,E) attends over media (B,M,E): no mask, no RoPE; K5 with
    ``causal=False`` (M != S).  ``kv``: the :func:`cross_attention_kv` of
    this media in x's type, where the caller has them (the prefill, which
    caches them); the reference computes them here again, to the same
    bits."""
    k, v = (kv if kv is not None
            else cross_attention_kv(params, cfg, media.to(x.dtype)))
    out = _flash(_cross_q(params, cfg, x), k, v, causal=False, window=0)
    return constrain(_out_proj(params, out), ("batch", "seq", "embed_act"))


def cross_attention_cached(params, cfg: ModelConfig, x, k, v):
    """Cross-attention against the cached (already k-normed) K/V (B,M,K,D):
    only q is normed.  The reference's plain softmax over every key (the
    decode's one token; no mask is built)."""
    out = _gqa_scores_softmax_out(cfg, _cross_q(params, cfg, x), k, v, None)
    return constrain(_out_proj(params, out), ("batch", "seq", "embed_act"))


# ---------------------------------------------------------------------------
# MLA (deepseek-v2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_template(cfg: ModelConfig):
    E, H = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    t = {
        "wkv_a": spec((E, kr + dr), ("embed", None)),
        "kv_norm": rmsnorm_template(kr),
        "wkv_b": spec((kr, H, dn + dv), ("kv_lora", "heads", None)),
        "wo": spec((H, dv, E), ("heads", None, "embed")),
    }
    if qr > 0:
        t["wq_a"] = spec((E, qr), ("embed", "q_lora"))
        t["q_norm"] = rmsnorm_template(qr)
        t["wq_b"] = spec((qr, H, dn + dr), ("q_lora", "heads", None))
    else:
        t["wq"] = spec((E, H, dn + dr), ("embed", "heads", None))
    return t


def _mla_q(params, cfg, x):
    """The query heads (B,S,H,dn+dr), through the q LoRA when there is one."""
    dt = x.dtype
    if cfg.q_lora_rank > 0:
        wq_a = weight_gather(params.cast("wq_a", dt), ("embed", "q_lora"))
        cq = rmsnorm(params["q_norm"], _flat_mm(x, wq_a), cfg.norm_eps)
        return _proj(cq, weight_gather(params.cast("wq_b", dt),
                                       ("q_lora", "heads", None)))
    return _proj(x, weight_gather(params.cast("wq", dt),
                                  ("embed", "heads", None)))


def _mla_kv(params, cfg, x, positions, gather: bool = False):
    """The compressed key/value rows of x, what the cache keeps: c_kv
    (B,S,kv_lora_rank), normed, and the shared RoPE key (B,S,dr), rotated.
    ``gather``: wkv_a through :func:`weight_gather` (the prefill's read)."""
    kr = cfg.kv_lora_rank
    wkv_a = params.cast("wkv_a", x.dtype)
    if gather:
        wkv_a = weight_gather(wkv_a, ("embed", None))
    ckv = _flat_mm(x, wkv_a)
    c_kv = rmsnorm(params["kv_norm"], ckv[..., :kr], cfg.norm_eps)
    k_rope = rope(ckv[..., kr:][:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_prefill(params, cfg: ModelConfig, x, positions):
    """Full-sequence MLA (train / prefill) -> (out (B,S,E), c_kv, k_rope),
    the last two the rows of the compressed cache.  q = [q_nope,
    rope(q_rope)] and k = [k_nope, rope(k_rope) on every head], (B,S,H,dn+dr)
    each, and v (B,S,H,dv) go through K5 in one call, scaled by
    ``1/sqrt(dn + dr)`` (the reference's scale).  The reference sums two
    products for the scores (no-RoPE and RoPE dims) and, past
    ``attention_chunk_min_t``, streams key blocks; K5 takes the one
    (dn + dr)-wide product for both, which differs in f32 only in the order
    of the sums.  ``attention_impl="dense"``: the reference's dense branch
    (:func:`_mla_dense`) instead of K5."""
    dt = x.dtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    B, S = x.shape[:2]
    q = _mla_q(params, cfg, x)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)],
                  dim=-1)
    c_kv, k_rope = _mla_kv(params, cfg, x, positions, gather=True)
    wkv_b = weight_gather(params.cast("wkv_b", dt), ("kv_lora", "heads", None))
    kv = _proj(c_kv, wkv_b)                              # (B,S,H,dn+dv)
    H = kv.shape[2]
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    if _dense(cfg):
        out = _mla_dense(cfg, q, k, kv[..., dn:])
    else:
        out = _flash(q, k, kv[..., dn:], causal=True)
    out = constrain(_out_proj(params, out, gather=True),
                    ("batch", "seq", "embed_act"))
    return out, c_kv, k_rope


def _mla_dense(cfg, q, k, v):
    """The reference's dense MLA (``attention_impl="dense"``): q/k (B,S,H,
    dn+dr), v (B,S,H,dv); the scores two summed products, of the no-RoPE
    and of the RoPE dims, in the compute type, lifted to f32 by the scale;
    the causal softmax's probabilities rounded to the compute type.  Under
    a mesh on each rank's heads (:func:`_by_heads`)."""
    if is_distributed(q, k, v):
        return _by_heads(lambda ql, kl, vl: _mla_dense(cfg, ql, kl, vl),
                         q, k, v)
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    S = q.shape[1]
    scores = (torch.einsum("bshd,bthd->bhst", q[..., :dn], k[..., :dn])
              + torch.einsum("bshd,bthd->bhst", q[..., dn:], k[..., dn:]))
    scores = scores.float() * (1.0 / math.sqrt(dn + dr))
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def mla_apply(params, cfg: ModelConfig, x, positions):
    """Full-sequence MLA (train / prefill); positions are ``arange(S)``."""
    return mla_prefill(params, cfg, x, positions)[0]


def mla_decode(params, cfg: ModelConfig, x, cache_ckv, cache_krope, pos):
    """One-token MLA decode against the compressed cache (B,T,kv_lora_rank)
    + (B,T,dr), with the reference's absorbed query: q_nope goes through
    wkv_b's key half, so the scores and the weighted sum run in the
    kv_lora space and the cache is never expanded to heads.  Writes the
    token's rows into the caches in place at ``pos`` (a 1-element int64
    tensor or an int, :func:`decode_position`) without reading it on the
    host, and returns ``(out, cache_ckv, cache_krope)``."""
    dt = x.dtype
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    B = x.shape[0]
    pos = decode_position(pos, x.device)
    positions = pos.view(1, 1).expand(B, 1)
    q = _mla_q(params, cfg, x)
    q_nope = q[..., :dn]
    q_rope = rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv, k_rope = _mla_kv(params, cfg, x, positions)
    cache_write(cache_ckv, pos, c_kv)
    cache_write(cache_krope, pos, k_rope)

    wkv_b = params.cast("wkv_b", dt)                      # (kr, H, dn+dv)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wkv_b[..., :dn])
    ckv = constrain(cache_ckv, _CACHE_AXES[:3]).to(dt)
    krope = constrain(cache_krope, _CACHE_AXES[:3]).to(dt)
    out_c = _mla_attention(q_abs, q_rope, ckv, krope, pos,
                           1.0 / math.sqrt(dn + dr))      # (B,1,H,kr)
    out = torch.einsum("bshr,rhd->bshd", out_c, wkv_b[..., dn:])
    return _out_proj(params, out), cache_ckv, cache_krope


def _mla_attention(q_abs, q_rope, ckv, krope, pos, scale):
    """The absorbed query's attention over the compressed cache ckv/krope
    (B,T,·) at ``pos`` -> out_c (B,1,H,kr).  A cache whose positions the
    ranks split runs flash-decode (:func:`_flash_decode_mla`); otherwise
    the reference's softmax over every position."""
    if positions_split(ckv):
        return _flash_decode_mla(q_abs, q_rope, ckv, krope, pos, scale)
    # the reference's scale is a numpy float64, which lifts the bf16 sum
    # of the two products to f32 before it scales
    scores = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, krope)).float()
    scores = scores * scale
    mask = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    w = torch.softmax(torch.where(mask, scores, NEG_INF),
                      dim=-1).to(q_abs.dtype)
    return torch.einsum("bhst,btr->bshr", w, ckv)


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
    h = x @ weight_gather(params.cast("wi", dt), ("embed", "mlp"))
    if "wg" in params:
        g = x @ weight_gather(params.cast("wg", dt), ("embed", "mlp"))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    h = constrain(h, ("batch", "seq", "mlp_act"))
    out = h @ weight_gather(params.cast("wo", dt), ("mlp", "embed"))
    return constrain(out, ("batch", "seq", "embed_act"))


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


#: the logical axes of the reference's dispatch grids, each for the grid
#: and for its hidden activations: the batch-local grids (B, X, C, E) and
#: the global grid (X, C, E)
_LOCAL_GRID = ("batch", "experts", None, None)
_GLOBAL_GRID = ("experts", "moe_cap", None)
#: a batch's tokens (B, S, E) and their routing (B, S, K)
_TOKENS = ("batch", None, None)


def _experts(params, h, dt, fence=None):
    """The SwiGLU experts on (X, rows, E) -> (X, rows, E), one batched
    product a weight; ``h`` may broadcast over X.  ``fence``: the
    reference's constraint of a grid, applied to the grid and to its hidden
    activations."""
    wi = weight_gather(params.cast("wi", dt), ("experts", "embed", "mlp"))
    wg = weight_gather(params.cast("wg", dt), ("experts", "embed", "mlp"))
    wo = weight_gather(params.cast("wo", dt), ("experts", "mlp", "embed"))
    if fence is not None:
        h = fence(h)
    g = torch.matmul(h, wg)
    h = F.silu(g) * torch.matmul(h, wi)
    if fence is not None:
        h = fence(h)
    return torch.matmul(h, wo)


def _combine(ye, cell, top_p):
    """out[t] = sum over k of ye[cell[t, k]] * top_p[t, k], in slot order.
    ye: (cells, E) with a zero row where ``cell`` points for a dropped
    pair; cell, top_p: (T, K)."""
    return (ye[cell] * top_p[..., None]).sum(dim=1)


def _rows_at(x, idx):
    """The rows of x (n, E) at the indices ``idx``, a zero row where an
    index is n -> idx.shape + (E,)."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])])[idx]


def _moe_plan(top_i, X: int, groups: int, C: int):
    """The capacity routing of the (token, slot) pairs ``top_i`` (T, K)
    over ``groups`` equal runs of tokens (the batch rows for the batch-local
    grids, 1 for the global grid): within a group the pairs are sorted
    stably by expert, and a pair whose rank in its expert is C or more is
    dropped.  -> (tok (groups, X, C): the token of each cell of the (X,
    groups, C) grid, T where it is empty; cell (T, K): each pair's cell of
    that grid, flattened, X·groups·C where the pair was dropped; the
    dropped pairs, a 0-d tensor).  Integers, on plain tensors."""
    dev = top_i.device
    T, K = top_i.shape
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
    g = torch.arange(groups, device=dev)[:, None]
    cell_sorted = torch.where(keep, (e_sorted * groups + g) * C + rank,
                              X * groups * C)
    cell = torch.empty_like(cell_sorted).scatter_(1, order, cell_sorted)
    # the pair that fills cell (x, g, c) is the group's sorted pair
    # starts[g, x] + c, if c < counts[g, x]
    c = torch.arange(C, device=dev)
    at = (starts[:, :, None] + c).clamp(max=N - 1).reshape(groups, X * C)
    pair = order.gather(1, at).reshape(groups, X, C)
    tok = torch.where(c < counts[:, :, None],
                      g[:, :, None] * (T // groups) + pair // K, T)
    return tok, cell.reshape(T, K), (~keep).sum()


def _partial_grid(tokens_pl, grid_pl) -> tuple:
    """The placements of a grid that each rank fills from its own tokens
    (``tokens_pl``, their batch along dim 0): partial sums on the mesh
    dimensions that shard the tokens, the grid's experts (dim 0) where
    ``grid_pl`` shards them, replicated elsewhere."""
    out = []
    for t, g in zip(tokens_pl, grid_pl):
        experts = isinstance(g, Shard) and g.dim == 0
        if isinstance(t, Shard) and experts:
            raise ValueError(f"one mesh dimension shards both the tokens "
                             f"{tokens_pl} and the grid's experts {grid_pl}")
        out.append(Partial() if isinstance(t, Shard)
                   else g if experts else Replicate())
    return tuple(out)


def _combine_grid(ye, axes, cell, top_p, lead=None, cells=None, pad=True):
    """out (B, S, E): each token's K expert outputs, the rows of ``ye`` at
    ``cell`` (B, S, K), weighted by ``top_p`` (B, S, K) and summed in slot
    order (:func:`_combine`); ``pad``: a dropped pair's cell points past
    the rows, at a zero row.  ``ye``: the experts' outputs in a grid whose
    dim 0 is the experts once ``lead`` (a view) has put them first;
    ``cells``: ``cell`` from the routing, on local tensors (the dropless
    form's).  Under a mesh it runs on each rank's local shards, ``ye`` at
    the logical axes ``axes``: a rank that holds a block of the experts
    sums the pairs of its experts and points the others at its zero row,
    so its sums are partial over the experts' mesh dimensions."""
    B, S, K = cell.shape
    E = ye.shape[-1]

    def local(yl, cl, pl, pls=None):
        bl = cl.shape[0]
        if cells is not None:
            cl = cells(cl)
        if lead is not None:
            yl = lead(yl)
        xl = yl.shape[0]
        rows = yl.reshape(-1, E)
        xi, xn = (0, 1) if pls is None else shard_block(active_mesh(),
                                                        pls[0], xdim)
        if xn > 1:                      # this rank's experts
            per = rows.shape[0] // xl
            e = cl // per
            cl = torch.where((e >= xi * xl) & (e < (xi + 1) * xl),
                             cl - xi * xl * per, xl * per)
        if pad or xn > 1:
            rows = torch.cat([rows, rows.new_zeros(1, E)])
        return _combine(rows, cl.reshape(-1, K),
                        pl.reshape(-1, K)).reshape(bl, S, E)

    xdim = 1 if lead is not None else 0
    if not is_distributed(ye, cell, top_p):
        return local(ye, cell, top_p)
    ye_pl = mesh_placements(axes, ye.shape)
    out_pl = tuple(Partial() if isinstance(y, Shard) and y.dim == xdim
                   else t for t, y in zip(
                       mesh_placements(_TOKENS, (B, S, E)), ye_pl))
    return run_local(local, [(ye, axes), (cell, _TOKENS), (top_p, _TOKENS)],
                     [(out_pl, (B, S, E))])


def _moe_grid_local(params, x, top_p, top_i, X, C):
    """The reference's batch-local grids (``moe_impl="grid_local"``): a
    capacity grid a batch row, (B, X, C, E), whose gathered rows and hidden
    activations are constrained to ``("batch", "experts", None, None)``.
    Under a mesh each rank routes its own batch rows on its local shards
    (no collective) and fills its block of the experts.  Products run on
    the grid as (X, B·C, E), a view of it.  -> (out (B, S, E), dropped
    pairs, a 0-d tensor: under a mesh partial over the batch's mesh
    dimensions)."""
    dt = x.dtype
    B, S, E = x.shape
    K = top_i.shape[-1]
    meshed = is_distributed(x, top_i)
    xi, xn = (shard_block(active_mesh(), mesh_placements(
        _LOCAL_GRID, (B, X, C, E)), 1) if meshed else (0, 1))

    def dispatch(xl, il, _pls=None):
        bl = xl.shape[0]
        tok, cell, dropped = _moe_plan(il.reshape(bl * S, K), X, bl, C)
        if xn > 1:                      # this rank's experts
            tok = tok[:, xi * X // xn:(xi + 1) * X // xn]
        xg = _rows_at(xl.reshape(bl * S, E), tok.transpose(0, 1))
        return xg.transpose(0, 1), cell.reshape(bl, S, K), dropped

    if meshed:
        batch = mesh_placements(_TOKENS, (B, S, E))
        xg, cell, dropped = run_local(
            dispatch, [(x, _TOKENS), (top_i, _TOKENS)],
            [(_LOCAL_GRID, (B, X, C, E)), (_TOKENS, (B, S, K)),
             (tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in batch), ())])
    else:
        xg, cell, dropped = dispatch(x, top_i)

    def grid(t):        # (X, B·C, n) -> the (B, X, C, n) grid, a view
        return reshape(t, (X, B, C, t.shape[-1])).transpose(0, 1)

    def rows(t):        # the grid -> (X, B·C, n)
        return reshape(t.transpose(0, 1), (X, B * C, t.shape[-1]))

    ye = _experts(params, rows(xg), dt,
                  lambda t: rows(constrain(grid(t), _LOCAL_GRID)))
    out = _combine_grid(grid(ye), _LOCAL_GRID, cell, top_p,
                        lead=lambda y: y.transpose(0, 1))
    return out, dropped


def _moe_grid_global(params, x, top_p, top_i, X, C):
    """The reference's global grid (``moe_impl="grid"``): one capacity grid
    (X, C, E) over all B·S tokens in their global order, the grid and its
    hidden activations constrained to ``("experts", "moe_cap", None)``.
    Under a mesh every rank ranks all the pairs (the (B, S, K) experts
    gathered over the batch: integers), so a sharded run keeps and drops
    the pairs one process does.  Each rank fills the rows of its block of
    the experts from its own tokens, zeros where another rank holds the
    token, and the grid's constraint sums the ranks' grids over the batch's
    mesh dimensions (an all-reduce, a reduce-scatter where "moe_cap"
    shards).  The combine brings each expert's rows back to the ranks of
    its tokens.  -> (out (B, S, E), dropped pairs, a 0-d tensor)."""
    dt = x.dtype
    B, S, E = x.shape
    K = top_i.shape[-1]
    T = B * S
    meshed = is_distributed(x, top_i)
    xi, xn, bi, bn = 0, 1, 0, 1
    if meshed:
        mesh = active_mesh()
        batch = mesh_placements(_TOKENS, (B, S, E))
        grid_pl = _partial_grid(batch, mesh_placements(_GLOBAL_GRID,
                                                       (X, C, E)))
        (xi, xn), (bi, bn) = (shard_block(mesh, grid_pl, 0),
                              shard_block(mesh, batch, 0))

    def dispatch(xl, il, _pls=None):
        tok, cell, dropped = _moe_plan(il.reshape(T, K), X, 1, C)
        tok, tl = tok[0], xl.shape[0] * S
        if xn > 1:                      # this rank's experts
            tok = tok[xi * X // xn:(xi + 1) * X // xn]
        if bn > 1:                      # this rank's tokens
            tok = tok - bi * tl
            tok = torch.where((tok >= 0) & (tok < tl), tok, tl)
            cell = cell[bi * tl:(bi + 1) * tl]
        return (_rows_at(xl.reshape(tl, E), tok), cell.reshape(-1, S, K),
                dropped)

    if meshed:
        xg, cell, dropped = run_local(
            dispatch, [(x, _TOKENS), (top_i, (None, None, None))],
            [(grid_pl, (X, C, E)), (_TOKENS, (B, S, K)), ((), ())])
    else:
        xg, cell, dropped = dispatch(x, top_i)
    ye = _experts(params, xg, dt, lambda t: constrain(t, _GLOBAL_GRID))
    return _combine_grid(ye, ("experts", None, None), cell, top_p), dropped


def _moe_dropless(params, xt, top_p, top_i, X):
    """Dropless dispatch (the reference's ``ragged_dot``): every expert
    runs every token, one batched product a weight whatever the routing,
    and each token takes the rows of its K experts (xt (T, E); top_p,
    top_i (B, S, K); -> (B, S, E)).  The products a pair needs are the ones
    ``ragged_dot`` computes; the other X - K rows a token cost X/K times
    the work, which keeps the launch count independent of the routing.  It
    also reads every expert's weights, where ``ragged_dot`` reads only
    those of the experts that hold a pair, at most T·K of the X: at the
    decode's 4 tokens that is 32 of granite's 40 experts but 24 of
    deepseek-v2's 160, so there the step reads at least 160/24 = 6.7 times
    the expert bytes it needs (ROADMAP.md, Queue 1).  Under a mesh the
    rows are gathered by cell on each rank's local shards
    (:func:`_combine_grid`)."""
    B, S, K = top_i.shape
    E = xt.shape[-1]
    ye = _experts(params, xt[None], xt.dtype)            # (X, T, E)

    def cells(il):                      # a local token's row of its expert
        n = il.shape[0] * S
        return il * n + torch.arange(n, device=il.device).view(-1, S, 1)

    return _combine_grid(reshape(ye, (X, B, S, E)),
                         ("experts", "batch", None, None), top_i, top_p,
                         cells=cells, pad=False)


def moe_apply(params, cfg: ModelConfig, x, dropless: bool = False,
              routing: list | None = None):
    """x: (B,S,E).  Top-k routing (softmax in f32, the top k
    renormalised), then one of the reference's three dispatch forms:

    * ``dropless=True`` or ``moe_impl="ragged"``: exact, no capacity
      (:func:`_moe_dropless`; the reference's decode path);
    * ``moe_impl="grid"``: one capacity grid over all B·S tokens, C =
      ceil(B·S·K/X·cf) (:func:`_moe_grid_global`);
    * otherwise (``"grid_local"``): a grid a batch row, C = ceil(S·K/X·cf)
      (:func:`_moe_grid_local`).

    Pairs past capacity are dropped (standard capacity-factor semantics).
    Shared experts, if any, are added after.  ``routing``, a list, gets one
    :class:`Routing` a call.  Under a mesh the routing's bookkeeping
    (argsort, counts, ranks, cells) and the gathers by index run on each
    rank's local shards (:func:`~repro_torch.distributed.sharding.
    run_local`); the products and the reference's constraints on DTensors."""
    dt = x.dtype
    B, S, E = x.shape
    X, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = reshape(x, (T, E))

    logits = xt @ params.cast("router", dt)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = _top_k(probs, K)
    top_p = (top_p / top_p.sum(dim=-1, keepdim=True)).to(dt)
    bp, bi = reshape(top_p, (B, S, K)), reshape(top_i, (B, S, K))

    if dropless or cfg.moe_impl == "ragged":
        out, dropped = _moe_dropless(params, xt, bp, bi, X), None
    elif cfg.moe_impl == "grid":
        out, dropped = _moe_grid_global(params, x, bp, bi, X,
                                        _capacity(T, cfg))
    else:
        out, dropped = _moe_grid_local(params, x, bp, bi, X,
                                       _capacity(S, cfg))
    if cfg.n_shared_experts > 0:
        out = out + mlp_apply(params["shared"], x)
    out = constrain(out, ("batch", "seq", "embed_act"))
    if routing is not None:
        if dropped is None:
            dropped = torch.zeros((), dtype=torch.int64, device=x.device)
        routing.append(Routing(top_i, dropped))
    return out


def moe_aux_loss(params, cfg: ModelConfig, x):
    """Load-balancing auxiliary loss (Switch-style f*P), the reference's
    ``moe_aux_loss``: X times the sum over experts of the share of (token,
    slot) pairs routed to each and its mean router probability.  As in the
    reference, the train step's loss does not add it."""
    dt = x.dtype
    T = x.shape[0] * x.shape[1]
    X, K = cfg.n_experts, cfg.experts_per_token
    logits = (x @ params.cast("router", dt)).reshape(T, -1)
    probs = torch.softmax(logits.float(), dim=-1)
    top_i = _top_k(probs, K)[1]
    f = torch.bincount(top_i.reshape(-1), minlength=X).float() / (T * K)
    return X * torch.sum(f * probs.mean(dim=0))
