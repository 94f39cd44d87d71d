"""K5's gradient off the card: the plain backward
``ref.flash_attention_bwd_ref`` against ``torch.autograd`` through the
plain forward and against ``jax.grad`` of the reference's XLA attention
(``repro.nn.layers._gqa_scores_softmax_out`` and, blockwise,
``_gqa_chunked_attention``), the log-sum-exp's plain version against
``jax.nn.logsumexp`` of the reference's masked scores, emulations of
``csrc/flash_bwd.cu``'s and ``csrc/flash_bwd_tc.cu``'s algorithms within
``ops.bwd_tolerance`` of their variants, the backward's routing rule
(``ops.bwd_variant``), the wrapper's autograd Function, the build's hash of
a source's headers, and K6's refusal to run under autograd off the CPU.

Tolerances.  In f32 the three differ only in the order of their sums: each
gradient at ``rtol = atol = 1e-5`` (atol relative to the gradient's
largest element).  The emulation keeps the kernel's tiles, its two passes
(each row's max and sum first, then p = exp(s - m) / l) and its order of
accumulation over key tiles (dq) and over the group's heads and query
tiles (dk, dv), and must lie within ``ops.bwd_tolerance`` of the plain
version, in f32 and, rounded as the kernel rounds its outputs, in bf16 and
f16.  The tensor-core kernel's emulation takes p from the log-sum-exp and
rounds P and dS to the inputs' type before their products, in bf16 and
f16.  The kernels themselves are held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as ref_layers
from repro_torch.kernels import KernelError
from repro_torch.kernels.flash_attention import ops
from repro_torch import _build
from repro_torch.kernels.flash_attention.ref import (LOG2E, attention_mask,
                                                    flash_attention_bwd_ref,
                                                    flash_attention_lse_ref,
                                                    flash_attention_ref)
from repro_torch.kernels.rwkv6 import ops as k6

CASES = [
    # B, H, K, S, T, D, DV, causal, window
    (2, 4, 2, 40, 40, 16, 16, True, 0),      # GQA causal, ragged tail
    (1, 4, 4, 70, 70, 32, 32, True, 24),     # sliding window, two tiles
    (1, 6, 2, 33, 80, 16, 16, False, 0),     # non-causal, T != S
    (1, 3, 1, 50, 30, 64, 64, True, 0),      # causal, S > T
    (1, 4, 2, 40, 40, 192, 128, True, 0),    # MLA's (q/k, v) head dims
    (1, 2, 1, 70, 66, 256, 256, True, 9),    # D 256 (32-wide tiles), window
]
#: a row with no visible key (window 5, S > T): its gradient is 0
EMPTY_ROWS = (1, 2, 1, 30, 20, 16, 16, True, 5)
IDS = [f"{'c' if c[7] else 'nc'}-S{c[3]}-T{c[4]}-D{c[5]}-{c[6]}-w{c[8]}"
       for c in CASES]
#: qwen2-1.5b's training heads (12 query and 2 kv heads of 128), cut in
#: length from 4096
QWEN_CUT = (1, 12, 2, 384, 384, 128, 128, True, 0)


def _inputs(case, seed=0):
    B, H, K, S, T, D, DV, causal, window = case
    rng = np.random.default_rng(seed + S * T + D)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((B, S, H, D), (B, T, K, D), (B, T, K, DV), (B, S, H, DV))]


def _close(got, want, tol=1e-5):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def _autograd(q, k, v, dout, causal, window):
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    out.backward(dout)
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("case", CASES + [EMPTY_ROWS], ids=IDS + ["empty"])
def test_plain_backward_equals_autograd(case):
    causal, window = case[7], case[8]
    q, k, v, dout = (torch.as_tensor(a) for a in _inputs(case))
    out, want = _autograd(q, k, v, dout, causal, window)
    got = flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                  window=window)
    for g, w in zip(got, want):
        _close(g, w)


def test_rows_without_a_key_get_no_gradient():
    B, H, K, S, T, D, DV, causal, window = EMPTY_ROWS
    q, k, v, dout = (torch.as_tensor(a) for a in _inputs(EMPTY_ROWS))
    empty = ~attention_mask(S, T, causal, window, "cpu").any(dim=-1)
    assert empty.any()
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                         window=window)
    assert (dq[:, empty] == 0).all() and (dq[:, ~empty] != 0).any()


def _jax_attention(causal, window, chunked):
    """The reference model's attention in f32 with K5's positional mask:
    ``_gqa_scores_softmax_out`` (dense) or ``_gqa_chunked_attention``
    (blockwise online softmax over 8-key blocks)."""
    def f(q, k, v):
        S, T = q.shape[1], k.shape[1]
        mask = jnp.asarray(attention_mask(S, T, causal, window, "cpu")
                           .numpy())
        if chunked:
            cfg = SimpleNamespace(window=window)
            pos_q = jnp.broadcast_to(jnp.arange(S), (q.shape[0], S))
            pos_k = jnp.broadcast_to(jnp.arange(T), (q.shape[0], T))
            return ref_layers._gqa_chunked_attention(
                cfg, q, k, v, pos_q, pos_k, window == 0, kblock=8)
        return ref_layers._gqa_scores_softmax_out(None, q, k, v,
                                                  mask[None, None, None])
    return f


def _jax_closed_form(causal, window):
    """The same softmax attention with v narrower than q and k (MLA),
    scaled by q's head dim."""
    def f(q, k, v):
        B, S, H, D = q.shape
        T, K = k.shape[1], k.shape[2]
        s = jnp.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, D),
                       k) / np.sqrt(D).astype(np.float32)
        mask = jnp.asarray(attention_mask(S, T, causal, window, "cpu")
                           .numpy())
        p = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
        return jnp.einsum("bkgst,btkd->bskgd", p, v).reshape(B, S, H, -1)
    return f


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_equals_jax_grad_of_reference_attention(case,
                                                               chunked):
    """Every row of these cases sees a key (the reference's softmax over
    an all-masked row is uniform, where K5's row is 0)."""
    B, H, K, S, T, D, DV, causal, window = case
    qn, kn, vn, gn = _inputs(case)
    if DV != D:
        if chunked:
            pytest.skip("the reference's blockwise attention takes DV == D")
        f = _jax_closed_form(causal, window)
    else:
        if chunked and (T % 8 or not causal):
            pytest.skip("the reference's blockwise attention is causal, "
                        "over blocks that divide T")
        f = _jax_attention(causal, window, chunked)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (qn, kn, vn)))
    want = vjp(jnp.asarray(gn))
    q, k, v, dout = (torch.as_tensor(a) for a in (qn, kn, vn, gn))
    got = flash_attention_bwd_ref(q, k, v, torch.as_tensor(np.array(out)),
                                  dout, causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, torch.as_tensor(np.array(w)))


# -- the kernel's algorithm ------------------------------------------------------

def emulate_bwd(q, k, v, out, dout, *, causal, window):
    """The arithmetic of ``flash_bwd.cu`` in torch, f32: tiles of 64 rows
    and 64 keys (32 at D = 256); launch 1 per query tile: Di from dout and
    out, each row's running max and sum over the key tiles (the forward's
    recurrence: ``l = exp(m - m_new) l + rowsum(exp(s - m_new))``), then
    over the key tiles again p = exp(s - m) / l (0 on a masked key and on
    a row with l = 0), dP, dS and dq accumulated tile by tile; launch 2 per
    key tile: dk and dv accumulated over the group's heads in order and,
    for each, over the query tiles in order.  -> f32 (dq, dk, dv) before
    the rounding to the inputs' type."""
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    BT = 32 if D == 256 else 64
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                     # (B,H,S,D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    gf = dout.float().permute(0, 2, 1, 3)
    di = (gf * out.float().permute(0, 2, 1, 3)).sum(-1)    # (B,H,S)
    mask = attention_mask(S, T, causal, window, q.device)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    tiles = range(0, T, BT)
    for k0 in tiles:
        s = (qf @ kf[:, :, k0:k0 + BT].transpose(-1, -2)) * scale
        valid = mask[:, k0:k0 + BT]
        s = torch.where(valid, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        rs = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0).sum(-1)
        l = torch.exp(m - m_new) * l + rs
        m = m_new

    def probs(s, valid):
        keep = valid & (l[..., None] > 0)
        return torch.where(keep, torch.exp(s * scale - m[..., None])
                           / l.clamp_min(1e-30)[..., None], 0.0)

    dq = torch.zeros((B, H, S, D))
    p_all, ds_all = [], []
    for k0 in tiles:
        kt, vt = kf[:, :, k0:k0 + BT], vf[:, :, k0:k0 + BT]
        p = probs(qf @ kt.transpose(-1, -2), mask[:, k0:k0 + BT])
        ds = p * (gf @ vt.transpose(-1, -2) - di[..., None])
        dq = dq + ds @ kt
        p_all.append(p)
        ds_all.append(ds)
    p, ds = torch.cat(p_all, -1), torch.cat(ds_all, -1)    # (B,H,S,T)
    dk = torch.zeros((B, K, T, D))
    dv = torch.zeros((B, K, T, DV))
    for g in range(G):
        h = torch.arange(K) * G + g
        for q0 in range(0, S, BT):
            rows = slice(q0, q0 + BT)
            dv = dv + p[:, h, rows].transpose(-1, -2) @ gf[:, h, rows]
            dk = dk + ds[:, h, rows].transpose(-1, -2) @ qf[:, h, rows]
    return ((dq * scale).permute(0, 2, 1, 3),
            (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", CASES + [EMPTY_ROWS], ids=IDS + ["empty"])
def test_emulated_kernel_within_stated_tolerance(case, dtype):
    causal, window = case[7], case[8]
    q, k, v, dout = (torch.as_tensor(a).to(dtype) for a in _inputs(case))
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    emu = emulate_bwd(q, k, v, out, dout, causal=causal, window=window)
    ref = flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                  window=window)
    tol = ops.bwd_tolerance("flash_bwd", dtype)
    for name, e, r in zip(("dq", "dk", "dv"), emu, ref):
        assert _rel_l2(e.to(dtype), r) <= tol, (name, _rel_l2(e.to(dtype), r))
    if dtype == torch.float32:       # the f32 paths alone: far inside
        assert max(_rel_l2(e, r) for e, r in zip(emu, ref)) <= 1e-5


@pytest.mark.parametrize("variant,dtype,want", [
    ("flash_bwd", torch.bfloat16, 2 * 2.0 ** -8),
    ("flash_bwd", torch.float16, 2 * 2.0 ** -11),
    ("flash_bwd", torch.float32, 1e-4),
    # the outputs' 2u and the rounded operands' (P, dS) 2u
    ("flash_bwd_tc", torch.bfloat16, 2 * 2.0 ** -8 + 2 * 2.0 ** -8),
    ("flash_bwd_tc", torch.float16, 2 * 2.0 ** -11 + 2 * 2.0 ** -11),
], ids=lambda x: str(x).replace("torch.", "") if not isinstance(x, float)
    else None)
def test_bwd_tolerance_is_twice_the_output_rounding(variant, dtype, want):
    """Each variant's stated tolerance: twice the output rounding (both
    sides round), and for the tensor-core kernel twice its operands'
    rounding on top."""
    assert ops.bwd_tolerance(variant, dtype) == want


@pytest.mark.parametrize("D,DV", [(16, 16), (32, 32), (64, 64), (128, 128),
                                  (256, 256), (192, 128)])
def test_backward_kernel_takes_every_forward_head_dim(D, DV):
    """Every (D, DV) the forward takes has a backward instance."""
    assert (D, DV) in ops.BWD_HEAD_DIMS
    assert ops.BWD_SOURCE.exists()
    for dtype in ops.DTYPES:
        variant = ops.bwd_variant(dtype, D, DV)
        assert ops.BWD_SOURCES[variant].exists()
        assert (D, DV) in (ops.BWD_TC_HEAD_DIMS if variant == "flash_bwd_tc"
                           else ops.BWD_HEAD_DIMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("D,DV", [(16, 16), (32, 32), (64, 64), (128, 128),
                                  (256, 256), (192, 128)])
def test_bwd_variant_routes_by_type_and_head_dims(dtype, D, DV):
    """The tensor-core backward takes bf16 and f16 at (64, 64), (128, 128)
    and (192, 128), a subset of what the tensor-core forward takes (so its
    forward can write the log-sum-exp); f32, D 16/32 and (256, 256) stay
    on the CUDA-core backward."""
    want = ("flash_bwd_tc" if dtype != torch.float32
            and (D, DV) in ((64, 64), (128, 128), (192, 128))
            else "flash_bwd")
    assert ops.bwd_variant(dtype, D, DV) == want
    if want == "flash_bwd_tc":
        assert ops.variant(dtype, D, DV) == "flash_tc"
    if DV == D:
        assert ops.bwd_variant(dtype, D) == want


# -- the tensor-core backward's algorithm -------------------------------------------

def emulate_bwd_tc(q, k, v, out, dout, lse, *, causal, window):
    """The arithmetic of ``flash_bwd_tc.cu`` in torch: p = exp2(s *
    scale_log2 - lse2) from the forward's log-sum-exp ``lse`` (B, H, S), 0
    on a masked key; Di from dout and out; dS = p (dP - Di); P and dS
    rounded to the inputs' type before their products (the tensor cores'
    A operands), every product and sum in f32.  Launch A: dq summed over
    64-key tiles in order.  Launch B, per query head: dk and dv summed over
    64-row query tiles in order, kept as that head's f32 partials.  Launch
    C: each kv head's partials summed in head order, dk then scaled by
    1/sqrt(D).  -> f32 (dq, dk, dv) before the rounding to the inputs'
    type."""
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[3]
    G, TILE = H // K, 64
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                     # (B,H,S,D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    gf = dout.float().permute(0, 2, 1, 3)
    di = (gf * out.float().permute(0, 2, 1, 3)).sum(-1)    # (B,H,S)
    mask = attention_mask(S, T, causal, window, q.device)
    s = qf @ kf.transpose(-1, -2)                          # unscaled
    p = torch.where(mask, torch.exp2(s * scale_log2 - lse[..., None]), 0.0)
    ds = p * (gf @ vf.transpose(-1, -2) - di[..., None])
    pr, dsr = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.zeros((B, H, S, D))
    for k0 in range(0, T, TILE):
        dq = dq + dsr[..., k0:k0 + TILE] @ kf[:, :, k0:k0 + TILE]
    dk_h = torch.zeros((B, H, T, D))
    dv_h = torch.zeros((B, H, T, DV))
    for q0 in range(0, S, TILE):
        rows = slice(q0, q0 + TILE)
        dv_h = dv_h + pr[:, :, rows].transpose(-1, -2) @ gf[:, :, rows]
        dk_h = dk_h + dsr[:, :, rows].transpose(-1, -2) @ qf[:, :, rows]
    dk_h, dv_h = (x.reshape(B, K, G, T, -1) for x in (dk_h, dv_h))
    dk, dv = dk_h[:, :, 0], dv_h[:, :, 0]
    for g in range(1, G):
        dk, dv = dk + dk_h[:, :, g], dv + dv_h[:, :, g]
    return ((dq * scale).permute(0, 2, 1, 3),
            (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", CASES + [EMPTY_ROWS, QWEN_CUT],
                         ids=IDS + ["empty", "qwen2-heads"])
def test_emulated_tc_kernel_within_stated_tolerance(case, dtype):
    """The tensor-core backward's algorithm, its operands rounded, within
    ``ops.bwd_tolerance("flash_bwd_tc", dtype)`` of the plain backward
    (both rounded to the inputs' type); a row with no valid key gets no
    gradient."""
    causal, window = case[7], case[8]
    q, k, v, dout = (torch.as_tensor(a).to(dtype) for a in _inputs(case))
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    emu = emulate_bwd_tc(q, k, v, out, dout, lse, causal=causal,
                         window=window)
    ref = flash_attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                  window=window)
    tol = ops.bwd_tolerance("flash_bwd_tc", dtype)
    for name, e, r in zip(("dq", "dk", "dv"), emu, ref):
        assert _rel_l2(e.to(dtype), r) <= tol, (name, _rel_l2(e.to(dtype), r))
    empty = ~attention_mask(case[3], case[4], causal, window, "cpu").any(-1)
    assert (emu[0][:, empty] == 0).all()


@pytest.mark.parametrize("case", CASES + [EMPTY_ROWS], ids=IDS + ["empty"])
def test_lse_ref_equals_jax_logsumexp_of_reference_scores(case):
    """``flash_attention_lse_ref`` is log2(e) times ``jax.nn.logsumexp`` of
    the scores that the reference's ``_gqa_scores_softmax_out`` forms (q
    k^T / sqrt(D), f32, under K5's positional mask), at 1e-5; a row with
    no valid key is +inf."""
    B, H, K, S, T, D, DV, causal, window = case
    qn, kn, vn, _ = _inputs(case)
    mask = attention_mask(S, T, causal, window, "cpu").numpy()
    qg = jnp.asarray(qn).reshape(B, S, K, H // K, D)
    scores = jnp.einsum("bskgd,btkd->bkgst", qg, jnp.asarray(kn)) / np.sqrt(
        D).astype(np.float32)
    want = np.array(jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf),
                                     axis=-1)).reshape(B, H, S) * LOG2E
    got = flash_attention_lse_ref(*(torch.as_tensor(a) for a in (qn, kn, vn)),
                                  causal=causal, window=window).numpy()
    empty = ~mask.any(-1)
    assert got.shape == (B, H, S) and got.dtype == np.float32
    assert np.isposinf(got[:, :, empty]).all()
    np.testing.assert_allclose(got[:, :, ~empty], want[:, :, ~empty],
                               rtol=1e-5, atol=1e-5)


def test_lse_gives_the_plain_probabilities():
    """exp2(s * log2(e) - lse2) is the plain version's softmax (f32, 1e-6),
    0 on a row with no valid key."""
    B, H, K, S, T, D, DV, causal, window = EMPTY_ROWS
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(EMPTY_ROWS))
    lse = flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(D)
    mask = attention_mask(S, T, causal, window, "cpu")
    p = torch.where(mask, torch.exp2(s * LOG2E - lse[..., None]), 0.0)
    want = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    want = torch.where(mask.any(-1)[:, None], want, 0.0)
    torch.testing.assert_close(p, want, rtol=1e-6, atol=1e-6)


def test_library_name_follows_the_included_header(tmp_path):
    """A source's library name hashes the local headers it includes (and
    theirs), so an edited header is rebuilt; the CUDA sources that share
    ``sm90.cuh`` name it."""
    src, top, sub = (tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh"))
    src.write_text('#include <cuda.h>\n#include "a.cuh"\nint x;\n')
    top.write_text('#include "b.cuh"\n')
    sub.write_text("// one\n")
    assert _build.local_headers(src) == [top, sub]
    first = _build.library_path(src)
    sub.write_text("// two\n")
    assert _build.library_path(src) != first
    for path in (ops.SOURCES["flash_tc"], ops.BWD_SOURCES["flash_bwd_tc"]):
        assert [h.name for h in _build.local_headers(path)] == ["sm90.cuh"]


# -- the wrapper under autograd ----------------------------------------------------

def test_wrapper_under_grad_uses_the_backward_on_the_cpu():
    """Under grad the wrapper's Function runs the forward's dispatch and the
    plain backward: its gradients are ``flash_attention_bwd_ref``'s bit for
    bit; no launch is counted on the CPU."""
    case = CASES[0]
    qn, kn, vn, gn = _inputs(case)
    q, k, v = (torch.as_tensor(a).requires_grad_(True) for a in (qn, kn, vn))
    dout = torch.as_tensor(gn)
    n0, b0 = ops.flash_attention.launches, ops.flash_attention.bwd_launches
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("_FlashAttention")
    out.backward(dout)
    want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                   out.detach(), dout, causal=True)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(g, w)
    assert (ops.flash_attention.launches, ops.flash_attention.bwd_launches) \
        == (n0, b0)
    with torch.no_grad():
        served = ops.flash_attention(q, k, v, causal=True)
    assert served.grad_fn is None and torch.equal(served, out.detach())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_refuses_what_it_cannot_take(dtype):
    """Off the CPU the backward launches or raises: a device that is not
    CUDA (meta tensors stand in for one here) is refused, on either
    variant's route, and an unknown variant is refused."""
    q = torch.empty((1, 8, 2, 128), device="meta", dtype=dtype)
    n0 = dict(ops.flash_attention.bwd_variant_launches)
    with pytest.raises(KernelError, match="CUDA"):
        ops.flash_attention_bwd(q, q, q, q, q)
    with pytest.raises(KernelError, match="CUDA"):
        ops.bwd_launch("flash_bwd_tc", q, q, q, q, q, lse=q)
    assert ops.flash_attention.bwd_variant_launches == n0


def test_plain_backward_takes_the_log_sum_exp_unread():
    """The plain backward stands in for the wrapper's: it takes ``lse`` and
    gives the same bits as without it."""
    q, k, v, dout = (torch.as_tensor(a) for a in _inputs(CASES[0]))
    out = flash_attention_ref(q, k, v, causal=True)
    lse = flash_attention_lse_ref(q, k, v, causal=True)
    for a, b in zip(flash_attention_bwd_ref(q, k, v, out, dout, lse=lse),
                    flash_attention_bwd_ref(q, k, v, out, dout)):
        assert torch.equal(a, b)


def test_wkv6_under_grad_off_the_cpu_is_checked_first():
    """K6 under grad off the CPU (a meta tensor stands in for a CUDA one)
    is refused by the device check before anything launches; the CPU's
    Function stays differentiable, its gradient the plain backward's."""
    B, S, H, D = 1, 8, 2, 4
    r, k, v, w = (torch.zeros((B, S, H, D), device="meta") for _ in range(4))
    u = torch.zeros((H, D), device="meta", requires_grad=True)
    n0 = (k6.wkv6.launches, k6.wkv6.bwd_launches)
    with pytest.raises(KernelError, match="one CUDA device"):
        k6.wkv6(r, k, v, w, u)
    assert (k6.wkv6.launches, k6.wkv6.bwd_launches) == n0
    g = torch.Generator().manual_seed(0)
    x = [torch.randn((B, S, H, D), generator=g) for _ in range(3)]
    logw = -torch.rand((B, S, H, D), generator=g)
    uc = torch.randn((H, D), generator=g, requires_grad=True)
    y, _ = k6.wkv6(*x, logw, uc)
    y.sum().backward()
    assert uc.grad is not None and torch.isfinite(uc.grad).all()
    want = k6.wkv6_bwd_ref(*x, logw, uc.detach(), torch.ones(y.shape))[4]
    assert torch.equal(uc.grad, want)
