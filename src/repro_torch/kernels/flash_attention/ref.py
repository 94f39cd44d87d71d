"""Plain PyTorch versions of the flash attention kernel (K5), of the
log-sum-exp that its tensor-core forward writes, and of its backward
kernels.

The closed form of ``repro.kernels.flash_attention.ref.attention_ref``, in
the model layout: f32 scores scaled by ``1/sqrt(D)``, the positional causal
and window mask (``q_pos - k_pos < window``) with ``NEG_INF``, a softmax in
f32, a row with no valid key giving 0, and the output in q's type.  Query
head h reads kv head ``h // (H // K)`` through a reshape, never a repeat.
f32 products run in full f32 (PyTorch's default: no TF32).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: K5's log-sum-exp is kept in the log2 domain of the kernels' exp2: for a
#: query row with scores s_t (scaled by 1/sqrt(D)) over its valid keys,
#: ``lse2 = LOG2E * log(sum_t exp(s_t))``, so that ``p_t = exp2(s_t * LOG2E
#: - lse2)``; a row with no valid key has ``lse2 = +inf`` (every p is 0).
#: ``flash_tc.cu`` writes it (B, H, S rounded up to :data:`BQ_LSE`), the
#: rows past S +inf; ``flash_bwd_tc.cu`` reads it.
LOG2E = 1.4426950408889634
#: the query rows of a forward tile: the log-sum-exp's rows are S rounded
#: up to a multiple of it
BQ_LSE = 128


def attention_mask(S: int, T: int, causal: bool, window: int, device):
    """(S, T) bool: key t is visible to query s (positions are indices)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,D); k: (B,T,K,D) with H % K == 0; v: (B,T,K,DV) ->
    (B,S,H,DV): the scores scaled by ``1/sqrt(D)``, q's and k's head dim (an
    MLA head's v is narrower than its q and k)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: H={H} is not a multiple of K={K}")
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(D)
    mask = attention_mask(S, T, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = torch.where(mask.any(dim=-1)[:, None, None, None], out, 0.0)
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """Each query row's log-sum-exp of its masked f32 scores, in the log2
    domain of :data:`LOG2E` -> (B, H, S) f32, +inf on a row with no valid
    key (v only fixes the call's form; it does not enter)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(D)
    mask = attention_mask(S, T, causal, window, q.device)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1) * LOG2E
    lse = torch.where(mask.any(dim=-1), lse, math.inf)       # (B,K,G,S)
    return lse.reshape(B, H, S)


def flash_attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                            window: int = 0, lse=None):
    """The gradient of :func:`flash_attention_ref` by its explicit backward
    equations, in f32: with p the forward's probabilities (0 on a masked key
    and on a row with no valid key), ``Di = rowsum(dout * out)`` from the
    forward's output ``out``, ``dS = p * (dout v^T - Di)``, ``dq = dS k /
    sqrt(D)``, ``dk = dS^T q / sqrt(D)`` and ``dv = p^T dout``, each kv
    head's summed over its group's query heads.  -> (dq, dk, dv) in the
    types of q, k and v.  ``csrc/flash_bwd.cu`` and ``csrc/flash_bwd_tc.cu``
    compute the same.  ``lse`` (the forward's log-sum-exp, which
    ``flash_bwd_tc.cu`` reads) is taken and not read, so that this function
    stands in for the wrapper's backward: p is recomputed here."""
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    qf = q.float().reshape(B, S, K, G, D)
    kf, vf = k.float(), v.float()
    gf = dout.float().reshape(B, S, K, G, DV)
    di = (gf * out.float().reshape(B, S, K, G, DV)).sum(-1)   # (B,S,K,G)
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) / math.sqrt(D)
    mask = attention_mask(S, T, causal, window, q.device)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", gf, vf)
    ds = p * (dp - di.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) / math.sqrt(D)
    dv = torch.einsum("bkgst,bskgd->btkd", p, gf)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
