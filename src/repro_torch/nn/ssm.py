"""RWKV6 (Finch) sequence mixing: the time-mix with its WKV6 recurrence
(data-dependent per-channel decay w_t, bonus u) and the channel-mix.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{D x D} per head
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

The full-sequence time-mix (``chunked=True``: train / prefill) runs the
chunk-parallel recurrence through K6 (:mod:`repro_torch.kernels.rwkv6`):
the kernel on CUDA tensors, its plain version on CPU tensors.  The decode
step (``chunked=False``) runs the exact recurrence :func:`wkv6_scan` in
plain PyTorch, as the reference does.  The reference's Mamba head is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import ops as _k6
from repro_torch.kernels.rwkv6.ref import wkv6_scan
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.layers import rmsnorm, rmsnorm_template
from repro_torch.nn.param import spec

LORA_R = 64   # low-rank size for the data-dependent decay/mix loras


def rwkv6_template(cfg: ModelConfig):
    E = cfg.d_model
    t = {
        # token-shift mixing coefficients (ddlerp, simplified to one lora)
        "mu": spec((5, E), (None, "embed"), init="zeros"),     # r,k,v,w,g
        "mix_w1": spec((E, 5 * LORA_R), ("embed", None), scale=0.02),
        "mix_w2": spec((5, LORA_R, E), (None, None, "embed"), scale=0.02),
        # projections
        "wr": spec((E, E), ("embed", "heads")),
        "wk": spec((E, E), ("embed", "heads")),
        "wv": spec((E, E), ("embed", "heads")),
        "wg": spec((E, E), ("embed", "heads")),
        "wo": spec((E, E), ("heads", "embed")),
        # decay: w_t = exp(-exp(w0 + lora_w(x))), per channel
        "w0": spec((E,), ("embed",), init="zeros"),
        "dec_w1": spec((E, LORA_R), ("embed", None), scale=0.02),
        "dec_w2": spec((LORA_R, E), (None, "embed"), scale=0.02),
        "u": spec((E,), ("embed",), init="zeros"),             # bonus
        "ln_x": rmsnorm_template(E),                           # per-head group norm
    }
    return t


def heads(cfg: ModelConfig):
    """(H, D) of the WKV heads."""
    H = cfg.n_ssm_heads or (cfg.d_model // 64)
    return H, cfg.d_model // H


def _token_shift(x, last=None):
    """shift right by one; `last` (B,1,E) seeds position 0 (decode carry)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _rwkv_mix(params, x, xs):
    """Data-dependent lerp between x and shifted xs for the 5 streams."""
    dt = x.dtype
    xx = xs - x
    lora = (x + xx * 0.5) @ params.cast("mix_w1", dt)
    lora = torch.tanh(lora).reshape(*x.shape[:2], 5, LORA_R)
    delta = torch.einsum("bsir,ire->bsie", lora, params.cast("mix_w2", dt))
    mu = params.cast("mu", dt)  # (5, E)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (mu[None, None] + delta)
    return [mixed[:, :, i] for i in range(5)]  # r,k,v,w,g streams


def _rwkv_rkvwg(params, cfg, x, xs):
    dt = x.dtype
    H, D = heads(cfg)
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, xs)
    r = xr @ params.cast("wr", dt)
    k = xk @ params.cast("wk", dt)
    v = xv @ params.cast("wv", dt)
    g = xg @ params.cast("wg", dt)
    lw = xw @ params.cast("dec_w1", dt)
    lw = torch.tanh(lw) @ params.cast("dec_w2", dt)
    logw = -torch.exp(torch.clamp(params["w0"].float() + lw.float(), -8.0, 4.0))
    B, S = x.shape[:2]
    shp = (B, S, H, D)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), logw.reshape(shp),
            g.reshape(shp), params["u"].float().reshape(H, D))


def rwkv6_apply(params, cfg: ModelConfig, x, chunked=True, state=None):
    """Full-sequence RWKV6 time-mix. Returns (out, state_end, x_last).
    ``state`` is (wkv (B,H,D,D), the last token (B,1,E)) or None."""
    r, k, v, logw, g, u = _rwkv_rkvwg(
        params, cfg, x, _token_shift(x, None if state is None else state[1]))
    s0 = None if state is None else state[0]
    if chunked:
        y, s_end = _k6.wkv6(r, k, v, logw, u, state0=s0)
    else:
        y, s_end = wkv6_scan(r, k, v, logw, u, s0)
    B, S = x.shape[:2]
    H, D = u.shape
    # per-head group norm (RWKV6 uses GroupNorm with n_heads groups)
    y = rmsnorm({"scale": params["ln_x"]["scale"].reshape(H, D)},
                y.reshape(B, S, H, D).to(x.dtype), cfg.norm_eps)
    y = y.reshape(B, S, -1)
    y = y * F.silu(g.reshape(B, S, -1).to(x.dtype))
    out = y @ params.cast("wo", x.dtype)
    return out, s_end, x[:, -1:]


def rwkv6_channel_template(cfg: ModelConfig):
    E, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu_k": spec((E,), ("embed",), init="zeros"),
        "mu_r": spec((E,), ("embed",), init="zeros"),
        "wk": spec((E, F_), ("embed", "mlp")),
        "wv": spec((F_, E), ("mlp", "embed")),
        "wr": spec((E, E), ("embed", None)),
    }


def rwkv6_channel_apply(params, cfg: ModelConfig, x, last=None):
    dt = x.dtype
    xs = _token_shift(x, last)
    xx = xs - x
    xk = x + xx * params.cast("mu_k", dt)
    xr = x + xx * params.cast("mu_r", dt)
    k = torch.square(F.relu(xk @ params.cast("wk", dt)))
    v = k @ params.cast("wv", dt)
    # the reference's einsum("bse,ee->bse", xr, wr) reads the diagonal of wr
    r = torch.sigmoid(xr * torch.diagonal(params.cast("wr", dt)))
    return r * v, x[:, -1:]
