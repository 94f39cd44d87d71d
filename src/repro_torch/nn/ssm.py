"""RWKV6 (Finch) sequence mixing: the time-mix with its WKV6 recurrence
(data-dependent per-channel decay w_t, bonus u) and the channel-mix.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{D x D} per head
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

The full-sequence time-mix (``chunked=True``: train / prefill) runs the
chunk-parallel recurrence through K6 (:mod:`repro_torch.kernels.rwkv6`):
the kernel on CUDA tensors, its plain version on CPU tensors; under a mesh
it runs on each rank's local shards, r/k/v/log-decay, ``u`` and the state
split by head with the rules (:func:`_wkv6`).  The decode
step (``chunked=False``) runs the exact recurrence :func:`wkv6_scan` in
plain PyTorch, as the reference does.

The Mamba head (hymba's parallel SSM branch, :func:`mamba_apply`) is a
selective SSM whose linear recurrence ``h_t = decay_t * h_{t-1} + drive_t``
runs through :func:`associative_scan`, JAX's odd/even recursion in plain
PyTorch: the reference's is ``jax.lax.associative_scan``, XLA code and no
Pallas kernel, so the port combines in the same tree with no kernel of its
own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, is_distributed,
                                              reshape, run_local,
                                              weight_gather)
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
    # the five loras' channels are unsplit before they are told apart (a
    # mesh may have sharded them, and 5 need not divide its axis)
    lora = constrain(torch.tanh(lora), ("batch", "seq", None))
    lora = lora.reshape(*x.shape[:2], 5, LORA_R)
    delta = torch.einsum("bsir,ire->bsie", lora, params.cast("mix_w2", dt))
    mu = params.cast("mu", dt)  # (5, E)
    mixed = x[:, :, None, :] + xx[:, :, None, :] * (mu[None, None] + delta)
    # r,k,v,w,g streams, laid out as the activations (under a mesh the
    # einsum may leave the sequence sharded, which the projections' (B*S)
    # rows could then not be split by)
    return [constrain(mixed[:, :, i], ("batch", "seq", "embed_act"))
            for i in range(5)]


def _rwkv_rkvwg(params, cfg, x, xs):
    dt = x.dtype
    H, D = heads(cfg)
    xr, xk, xv, xw, xg = _rwkv_mix(params, x, xs)
    r = xr @ weight_gather(params.cast("wr", dt), ("embed", "heads"))
    k = xk @ weight_gather(params.cast("wk", dt), ("embed", "heads"))
    v = xv @ weight_gather(params.cast("wv", dt), ("embed", "heads"))
    g = xg @ weight_gather(params.cast("wg", dt), ("embed", "heads"))
    # the decay's lora laid out as the activations, so that neither it nor
    # its gradient is left sharded over the sequence (whose (B*S) rows the
    # products' gradients could then not be split by)
    lw = constrain(xw @ params.cast("dec_w1", dt), ("batch", "seq", None))
    lw = constrain(torch.tanh(lw) @ params.cast("dec_w2", dt),
                   ("batch", "seq", "embed_act"))
    logw = -torch.exp(torch.clamp(params["w0"].float() + lw.float(), -8.0, 4.0))
    B, S = x.shape[:2]
    shp = (B, S, H, D)
    return (reshape(r, shp), reshape(k, shp), reshape(v, shp),
            reshape(logw, shp), reshape(g, shp),
            reshape(params["u"].float(), (H, D)))


#: the logical axes of K6's operands under a mesh: split by head, as the
#: rwkv6 rules shard the projections' output channels
_SEQ_AXES = ("batch", "seq", "heads", None)
_U_AXES = ("heads", None)
_STATE_AXES = ("batch", "heads", None, None)


def _wkv6(r, k, v, logw, u, state0=None, fn=None):
    """Every K6 call (``fn`` None), and the decode's exact recurrence
    (``fn``: :func:`wkv6_scan`).  Plain tensors go to it as they are.
    Under a mesh (DTensors) it runs on each rank's local shards,
    r/k/v/log-decay, ``u`` and the state split by head with the same
    placements, and its outputs are wrapped back; the boundary is
    differentiable, so K6's backward kernel runs on the shards too."""
    def call(rl, kl, vl, wl, ul, sl, _pls=None):
        if fn is not None:
            return fn(rl, kl, vl, wl, ul, sl)
        return _k6.wkv6(rl, kl, vl, wl, ul, state0=sl)

    if not is_distributed(r, k, v, logw, u, state0):
        return call(r, k, v, logw, u, state0)
    B, S, H, D = r.shape
    return run_local(call, [(r, _SEQ_AXES), (k, _SEQ_AXES), (v, _SEQ_AXES),
                            (logw, _SEQ_AXES), (u, _U_AXES),
                            (state0, _STATE_AXES)],
                     [(_SEQ_AXES, (B, S, H, D)),
                      (_STATE_AXES, (B, H, D, D))])


def rwkv6_apply(params, cfg: ModelConfig, x, chunked=True, state=None):
    """Full-sequence RWKV6 time-mix. Returns (out, state_end, x_last).
    ``state`` is (wkv (B,H,D,D), the last token (B,1,E)) or None."""
    r, k, v, logw, g, u = _rwkv_rkvwg(
        params, cfg, x, _token_shift(x, None if state is None else state[1]))
    s0 = None if state is None else state[0]
    y, s_end = _wkv6(r, k, v, logw, u, state0=s0,
                     fn=None if chunked else wkv6_scan)
    B, S = x.shape[:2]
    H, D = u.shape
    # per-head group norm (RWKV6 uses GroupNorm with n_heads groups)
    y = rmsnorm({"scale": reshape(params["ln_x"]["scale"], (H, D))},
                reshape(y, (B, S, H, D)).to(x.dtype), cfg.norm_eps)
    y = reshape(y, (B, S, H * D))
    y = y * F.silu(reshape(g, (B, S, H * D)).to(x.dtype))
    out = y @ weight_gather(params.cast("wo", x.dtype), ("heads", "embed"))
    return constrain(out, ("batch", "seq", "embed_act")), s_end, x[:, -1:]


def rwkv6_channel_template(cfg: ModelConfig):
    E, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu_k": spec((E,), ("embed",), init="zeros"),
        "mu_r": spec((E,), ("embed",), init="zeros"),
        "wk": spec((E, F_), ("embed", "mlp")),
        "wv": spec((F_, E), ("mlp", "embed")),
        "wr": spec((E, E), ("embed", None)),
    }


def _diagonal(w):
    """``torch.diagonal(w)``; under a mesh, of the whole matrix on each rank
    (a sharded diagonal has no DTensor rule in every torch release)."""
    if not is_distributed(w):
        return torch.diagonal(w)
    return run_local(lambda m, _pls: torch.diagonal(m), [(w, (None, None))],
                     [((None,), (w.shape[0],))])


def rwkv6_channel_apply(params, cfg: ModelConfig, x, last=None):
    dt = x.dtype
    xs = _token_shift(x, last)
    xx = xs - x
    xk = x + xx * params.cast("mu_k", dt)
    xr = x + xx * params.cast("mu_r", dt)
    k = xk @ weight_gather(params.cast("wk", dt), ("embed", "mlp"))
    k = constrain(torch.square(F.relu(k)), ("batch", "seq", "mlp_act"))
    v = k @ weight_gather(params.cast("wv", dt), ("mlp", "embed"))
    # the reference's einsum("bse,ee->bse", xr, wr) reads the diagonal of wr
    r = torch.sigmoid(xr * _diagonal(params.cast("wr", dt)))
    return constrain(r * v, ("batch", "seq", "embed_act")), x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hymba's parallel-SSM head)
# ---------------------------------------------------------------------------

CONV_K = 4


def mamba_template(cfg: ModelConfig):
    E, N = cfg.d_model, cfg.ssm_state
    return {
        "in_x": spec((E, E), ("embed", "mlp")),
        "in_z": spec((E, E), ("embed", "mlp")),
        "conv": spec((CONV_K, E), ("conv", "mlp"), scale=0.5),
        "wB": spec((E, N), ("mlp", "ssm"), scale=0.02),
        "wC": spec((E, N), ("mlp", "ssm"), scale=0.02),
        "wdt": spec((E, 1), ("mlp", None), scale=0.02),
        "dt_bias": spec((E,), ("mlp",), init="zeros"),
        "A_log": spec((E, N), ("mlp", "ssm"), init="zeros"),
        "D": spec((E,), ("mlp",), init="ones"),
        "out": spec((E, E), ("mlp", "embed")),
    }


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], ... along ``dim``; ``even`` is as long as
    ``odd`` or one longer."""
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_empty(shape)
    lead = (slice(None),) * dim
    out[lead + (slice(0, None, 2),)] = even
    out[lead + (slice(1, None, 2),)] = odd
    return out


def associative_scan(fn, elems, dim: int = 0):
    """The inclusive scan of ``fn`` over ``dim`` of the tuple of tensors
    ``elems``, by ``jax.lax.associative_scan``'s odd/even recursion: ``fn``
    combines adjacent pairs, the scan of that half-length sequence gives the
    odd outputs, ``fn`` of each odd output with the next even element gives
    the even outputs, element 0 goes first and the two interleave.  So
    every output is combined in the reference's tree and order.  About
    ``2 log2(S)`` calls of ``fn`` on halving lengths; no loop over S."""
    elems = tuple(elems)
    dim %= elems[0].dim()
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def part(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = fn(tuple(part(e, 0, n - 1, 2) for e in elems),
                 tuple(part(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    del reduced
    rest = tuple(part(e, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = fn(tuple(part(o, 0, -1) for o in odd), rest)
    else:
        even = fn(odd, rest)
    even = tuple(torch.cat([part(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def scan_combine(a, b):
    """The linear recurrence's combine, the reference's operands in its
    order: (decay, drive) then (decay, drive)."""
    return (a[0] * b[0], b[0] * a[1] + b[1])


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, max(x, 0) + log1p(exp(-|x|)),
    with no switch to ``x`` past a threshold (``F.softplus``'s)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _depthwise_conv(x, w, tail=None):
    """Causal depthwise conv, kernel CONV_K. x: (B,S,E); tail: (B,K-1,E)."""
    if tail is None:
        tail = x.new_zeros((x.shape[0], CONV_K - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(CONV_K))
    return out, xp[:, -(CONV_K - 1):]


def mamba_apply(params, cfg: ModelConfig, x, state=None):
    """Selective SSM. x: (B,S,E); ``state`` is (h (B,E,N) f32, the conv
    tail (B,CONV_K-1,E) in x's type) or None.  Returns (out, (h_end,
    conv_tail)).  The reference's cast points: the projections in the
    compute type, the step size, decay, drive and scan in f32."""
    dt_ = x.dtype
    f32 = torch.float32
    xb = x @ weight_gather(params.cast("in_x", dt_), ("embed", "mlp"))
    z = x @ weight_gather(params.cast("in_z", dt_), ("embed", "mlp"))
    h_tail = None if state is None else state[1]
    xc, tail = _depthwise_conv(xb, params.cast("conv", dt_), h_tail)
    # laid out as the activations, neither the conv's output nor B and C
    # sharded over the sequence (the products' (B*S) rows could then not
    # be split by it)
    xc = constrain(F.silu(xc), ("batch", "seq", "mlp_act"))

    Bm = constrain(xc @ params.cast("wB", dt_), ("batch", "seq", None)).to(f32)
    Cm = constrain(xc @ params.cast("wC", dt_), ("batch", "seq", None)).to(f32)
    delta = softplus((xc * params.cast("wdt", dt_)[:, 0]).to(f32)
                     + params["dt_bias"].to(f32))   # (B,S,E) step size
    A = -torch.exp(params["A_log"].to(f32))                   # (E,N)

    decay = torch.exp(delta[..., None] * A)                   # (B,S,E,N)
    drive = (delta * xc.to(f32))[..., None] * Bm[:, :, None, :]
    del delta
    if state is not None:
        decay = torch.cat([torch.ones_like(decay[:, :1]), decay], dim=1)
        drive = torch.cat([state[0].to(f32)[:, None], drive], dim=1)
    _, hs = associative_scan(scan_combine, (decay, drive), dim=1)
    del decay, drive
    if state is not None:
        hs = hs[:, 1:]
    B, S, E, N = hs.shape
    # einsum("bsen,bsn->bse") as one batched product
    y = torch.bmm(hs.reshape(B * S, E, N),
                  Cm.reshape(B * S, N, 1)).reshape(B, S, E)
    y = y + params["D"].to(f32) * xc.to(f32)
    # the scan's slices may leave the sequence sharded: unsplit it first
    y = constrain(y.to(dt_) * F.silu(z), ("batch", "seq", "mlp_act"))
    out = y @ weight_gather(params.cast("out", dt_), ("mlp", "embed"))
    return constrain(out, ("batch", "seq", "embed_act")), (hs[:, -1], tail)
