"""K5's tensor-core variant (``csrc/flash_tc.cu``) off the card: the
wrapper's dispatch rule and its TMA alignment check, and the tolerance the
variant is held to on the card, derived from its arithmetic.

The kernel rounds P to the input type before the PV product.  A test-only
emulation of that arithmetic (tiled online softmax over the kernel's key
tiles, exp2 with the folded scale, P rounded per key tile, f32 running
max, sum and accumulator) must lie within ``ops.tolerance("flash_tc", ...)``
of the plain version and of the Pallas kernel in interpret mode, and each
of its outputs within the derived bound ``u * sum_t p_t |v_t| / l`` of the
f32 closed form.  The kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_mask

# -- the dispatch rule ---------------------------------------------------------

RULE = {(dt, D): ("flash_tc" if dt != torch.float32 and D >= 64 else "flash")
        for dt in (torch.float32, torch.bfloat16, torch.float16)
        for D in (16, 32, 64, 128, 256)}


@pytest.mark.parametrize("dtype,D", sorted(RULE, key=str))
def test_variant_rule(dtype, D):
    """bf16 / f16 at D in (64, 128, 256) -> tensor cores; f32 anywhere and
    D in (16, 32) -> the CUDA-core kernel."""
    assert ops.variant(dtype, D) == RULE[dtype, D]


def test_variant_rule_reads_type_and_head_dim_only():
    assert {ops.variant(dt, D) for (dt, D) in RULE} == set(ops.SOURCES)
    assert all(ops.SOURCES[name].exists() for name in ops.SOURCES)


# -- the TMA alignment check ---------------------------------------------------

def _fused(B, S, heads, D, dtype):
    return torch.zeros((B, S, heads, D), dtype=dtype)


@pytest.mark.parametrize("case,want", [
    ("contiguous bf16 D=128", None),
    ("fused projection view, D=64", None),
    ("base one element off", "base address"),
    ("row stride of 5 heads x 36 elements", "not multiples of 16 bytes"),
    ("f32 D=6 head stride", "not multiples of 16 bytes"),
])
def test_tma_misalignment(case, want):
    if case == "contiguous bf16 D=128":
        t = _fused(2, 16, 12, 128, torch.bfloat16)
    elif case == "fused projection view, D=64":
        t = _fused(2, 16, 8 + 2 + 2, 64, torch.bfloat16)[:, :, 8:10]
    elif case == "base one element off":
        t = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 16, 2, 64)
    elif case == "row stride of 5 heads x 36 elements":
        t = _fused(2, 16, 5, 36, torch.bfloat16)[..., :32]
    else:
        t = _fused(2, 16, 3, 6, torch.float32)
    why = ops.tma_misalignment(t)
    if want is None:
        assert why is None
    else:
        assert why is not None and want in why


def test_cpu_call_runs_the_plain_version_on_either_rule():
    """On the CPU the wrapper never launches, whatever the rule names."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 64), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 8, 1, 64), generator=g).to(torch.bfloat16)
    n0 = ops.flash_attention.launches
    by0 = dict(ops.flash_attention.variant_launches)
    out = ops.flash_attention(q, k, k, causal=True)
    assert out.dtype == torch.bfloat16
    assert ops.flash_attention.launches == n0
    assert ops.flash_attention.variant_launches == by0


# -- the tolerance, derived from the kernel's arithmetic -----------------------

def emulate_tc(q, k, v, *, causal, window, round_p=True):
    """The arithmetic of ``flash_tc.cu`` in torch: key tiles of BK (128 at
    DV <= 128, 64 at DV = 256; DV is v's head dim, D q's and k's), scores
    in f32, masked keys -inf, a running max m (rows with no valid key yet
    keep -inf and use 0), p = exp2(s c - m c) with c = log2(e) / sqrt(D),
    alpha = exp2(m_old c - m c), P rounded to the input type before the PV
    product, f32 O and l.  -> the f32 output before its rounding to q's
    type."""
    B, S, H, D = q.shape
    T, K, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    BK = 128 if DV <= 128 else 64
    c = math.log2(math.e) / math.sqrt(D)
    qf = q.float().reshape(B, S, K, G, D).permute(0, 2, 3, 1, 4)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))
    mask = attention_mask(S, T, causal, window, q.device)
    m = torch.full((B, K, G, S), -math.inf)
    l = torch.zeros((B, K, G, S))
    acc = torch.zeros((B, K, G, S, DV))
    for k0 in range(0, T, BK):
        s = torch.einsum("bkgsd,bktd->bkgst", qf, kf[:, :, k0:k0 + BK])
        s = torch.where(mask[:, k0:k0 + BK], s, -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        mc = torch.where(mx == -math.inf, 0.0, mx) * c
        alpha = torch.exp2(m * c - mc)
        p = torch.exp2(s * c - mc[..., None])
        l = l * alpha + p.sum(-1)
        pr = p.to(q.dtype).float() if round_p else p
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,bktd->bkgsd", pr, vf[:, :, k0:k0 + BK])
        m = mx
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, DV)


def _weights_times_abs_v(q, k, v, causal, window):
    """sum_t p_t |v_t| / l of the f32 closed form, (B, S, H, DV), in f64."""
    B, S, H, D = q.shape
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.double().reshape(B, S, K, -1, D),
                     k.double()) / math.sqrt(D)
    mask = attention_mask(S, k.shape[1], causal, window, q.device)
    p = torch.softmax(torch.where(mask, s, -math.inf), dim=-1).nan_to_num(0.0)
    w = torch.einsum("bkgst,btkd->bskgd", p, v.double().abs())
    return w.reshape(B, S, H, v.shape[-1])


EMU_CASES = [
    # B, H, K, S, T, D, causal, window, logit scale (q, k), pallas tile
    (1, 12, 2, 256, 256, 128, True, 0, (1.0, 1.0), 128),   # qwen2 heads
    (1, 12, 2, 256, 256, 128, True, 0, (11.0, 28.0), 128),  # qwen2-1.5b's
    # strong logits: q and k near the standard deviations its init gives
    (1, 2, 1, 200, 200, 64, True, 48, (1.0, 1.0), 8),     # window, ragged
    (1, 2, 1, 160, 160, 256, True, 48, (1.0, 1.0), 32),    # gemma3 head dim
    (1, 4, 2, 130, 130, 64, True, 0, (1.0, 1.0), 26),      # ragged tail
    (1, 2, 1, 96, 200, 64, False, 0, (1.0, 1.0), 8),       # T != S
]


@pytest.mark.parametrize("B,H,K,S,T,D,causal,window,logits,tile", EMU_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_emulated_tc_arithmetic_within_stated_tolerance(
        B, H, K, S, T, D, causal, window, logits, tile, dtype):
    rng = np.random.default_rng(S * T + D + window)
    qn, kn, vn = (rng.standard_normal(shape, np.float32) * sc for shape, sc in
                  (((B, S, H, D), logits[0]), ((B, T, K, D), logits[1]),
                   ((B, T, K, D), 1.0)))
    q, k, v = (torch.as_tensor(a).to(dtype) for a in (qn, kn, vn))
    emu32 = emulate_tc(q, k, v, causal=causal, window=window)
    tol = ops.tolerance("flash_tc", dtype, v)
    assert tol["atol"] == ops.UNIT_ROUNDOFF[dtype] * float(v.abs().max())

    # the derived bound, element by element, against the f32 closed form on
    # the same (exactly representable) inputs: f32 arithmetic alone (sum
    # order, exp2 against exp) stays within 2**-13 of W = sum_t p_t |v_t| /
    # l, and rounding P adds at most u W
    ref32 = ops.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    W = _weights_times_abs_v(q, k, v, causal, window)
    slack = 2.0 ** -13 * W + 1e-6
    exact = emulate_tc(q, k, v, causal=causal, window=window, round_p=False)
    assert ((exact - ref32).abs().double() <= slack).all()
    assert ((emu32 - ref32).abs().double()
            <= ops.UNIT_ROUNDOFF[dtype] * W + slack).all()

    # the stated tolerance, in q's type, against the plain version and the
    # Pallas kernel (interpret mode; it needs tiles that divide S and T)
    got = emu32.to(dtype).float()
    ref = ops.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, ref.float(), **tol)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    pallas = pallas_flash(*(jnp.asarray(a, jdt) for a in (qn, kn, vn)),
                          causal=causal, window=window, bq=tile, bk=tile,
                          interpret=True)
    torch.testing.assert_close(
        got, torch.as_tensor(np.array(pallas.astype(jnp.float32))), **tol)
