"""K5 at MLA's head dims off the card: q and k 192 wide (deepseek-v2's 128
no-RoPE + 64 RoPE dims), v 128 wide.

The wrapper's rule sends bf16 / f16 at (192, 128) to the tensor-core
kernel (``csrc/flash_tc.cu``'s (DQK, DV) = (192, 128) instance) and every
other unequal pair to the CUDA-core kernel, which refuses it on the card.
The plain version takes v's head dim for its output and scales by
``1/sqrt(192)``: in f32 it equals the reference's MLA attention, which
sums two products for the scores (``src/repro/nn/layers.py``, the dense
branch of ``mla_apply``), within the f32 tolerance of ``ops.tolerance``
(the two differ in the order of f32 sums).  The emulation of
``flash_tc.cu``'s arithmetic (``tests/test_torch_flash_tc.py``) at (192,
128) lies within the tolerance the variant is held to on the card and
within the derived bound ``u * sum_t p_t |v_t| / l`` of the f32 closed
form.  The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_tc import _weights_times_abs_v, emulate_tc

from repro_torch.kernels.flash_attention import ops

DN, DR, DV = 128, 64, 128
NEG_INF = -1e30


@pytest.mark.parametrize("dtype,dqk,dv,want", [
    (torch.bfloat16, 192, 128, "flash_tc"),
    (torch.float16, 192, 128, "flash_tc"),
    (torch.float32, 192, 128, "flash"),
    (torch.bfloat16, 192, 192, "flash"),
    (torch.bfloat16, 128, 64, "flash"),
    (torch.bfloat16, 64, 128, "flash"),
    (torch.bfloat16, 256, 128, "flash"),
    (torch.bfloat16, 128, 128, "flash_tc"),
    (torch.bfloat16, 64, 64, "flash_tc"),
    (torch.float16, 256, 256, "flash_tc"),
    (torch.bfloat16, 32, 32, "flash"),
])
def test_variant_rule_with_v_head_dim(dtype, dqk, dv, want):
    """(192, 128) in bf16 / f16 is the tensor-core kernel's; any other
    unequal pair goes to the CUDA-core kernel (which raises on the card);
    equal pairs follow the one-D rule."""
    assert ops.variant(dtype, dqk, dv) == want
    if dqk == dv:
        assert ops.variant(dtype, dqk) == want


def _mla_inputs(rng, B, S, T, H):
    """MLA's pieces, f32 numpy: q_nope, q_rope (B,S,H,.), k_nope (B,T,H,DN),
    the shared k_rope (B,T,1,DR), v (B,T,H,DV)."""
    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return (n(B, S, H, DN), n(B, S, H, DR), n(B, T, H, DN), n(B, T, 1, DR),
            n(B, T, H, DV))


def _k5_inputs(q_nope, q_rope, k_nope, k_rope, v):
    """K5's q, k (k_rope on every head, contiguous) and v."""
    q = torch.cat([torch.as_tensor(q_nope), torch.as_tensor(q_rope)], -1)
    kr = torch.as_tensor(k_rope).expand(-1, -1, k_nope.shape[2], -1)
    k = torch.cat([torch.as_tensor(k_nope), kr], -1)
    return q, k, torch.as_tensor(v)


def _reference_mla_attention(q_nope, q_rope, k_nope, k_rope, v):
    """The dense branch of the reference's ``mla_apply``, causal, f32."""
    qn, qr, kn, kr, vv = (jnp.asarray(a) for a in (q_nope, q_rope, k_nope,
                                                   k_rope, v))
    S, T = qn.shape[1], kn.shape[1]
    scale = 1.0 / np.sqrt(DN + DR)
    scores = (jnp.einsum("bshd,bthd->bhst", qn, kn)
              + jnp.einsum("bshd,btxd->bhst", qr, kr)) * scale
    pos_q, pos_k = jnp.arange(S)[:, None], jnp.arange(T)[None, :]
    scores = jnp.where(pos_k <= pos_q, scores.astype(jnp.float32), NEG_INF)
    w = jax.nn.softmax(scores, axis=-1)
    return np.array(jnp.einsum("bhst,bthd->bshd", w, vv))


@pytest.mark.parametrize("B,S,H", [(2, 16, 4), (1, 130, 2), (2, 33, 3)])
def test_plain_version_equals_reference_mla_attention(B, S, H):
    """The plain version on the concatenated q/k and the narrower v equals
    the reference's two-product MLA scores, f32 (ops.tolerance's f32 one)."""
    rng = np.random.default_rng(S + H)
    pieces = _mla_inputs(rng, B, S, S, H)
    q, k, v = _k5_inputs(*pieces)
    got = ops.flash_attention_ref(q, k, v, causal=True)
    assert got.shape == (B, S, H, DV) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, torch.as_tensor(_reference_mla_attention(*pieces)),
        **ops.tolerance("flash", torch.float32, v))


def test_cpu_call_takes_a_narrower_v_and_launches_nothing():
    """On the CPU the wrapper runs the plain version at (192, 128) and
    returns v's head dim; v may be a view of a wider projection (the
    port's MLA passes ``kv[..., dn:]``)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 9, 2, DN + DR), generator=g).to(torch.bfloat16)
    k = torch.randn((1, 9, 2, DN + DR), generator=g).to(torch.bfloat16)
    kv = torch.randn((1, 9, 2, DN + DV), generator=g).to(torch.bfloat16)
    v = kv[..., DN:]
    assert ops.tma_misalignment(v) is None
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.shape == (1, 9, 2, DV) and out.dtype == torch.bfloat16
    assert ops.flash_attention.launches == n0
    assert torch.equal(out, ops.flash_attention_ref(q, k, v.contiguous(),
                                                    causal=True))


EMU_CASES = [
    # B, H, K, S, T, causal, window, logit scale of q
    (1, 4, 4, 256, 256, True, 0, 1.0),      # MLA: a kv head a query head
    (1, 4, 4, 256, 256, True, 0, 8.0),      # strong logits
    (1, 2, 2, 200, 200, True, 48, 1.0),     # window, ragged
    (1, 4, 2, 130, 130, True, 0, 1.0),      # GQA, ragged tail
    (1, 2, 1, 96, 200, False, 0, 1.0),      # T != S
]


@pytest.mark.parametrize("B,H,K,S,T,causal,window,qscale", EMU_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_emulated_tc_arithmetic_at_mla_dims(B, H, K, S, T, causal, window,
                                            qscale, dtype):
    """The emulation of ``flash_tc.cu`` at (192, 128): within the derived
    bound of the f32 closed form element by element, and within
    ``ops.tolerance("flash_tc", ...)`` of the plain version in q's type."""
    rng = np.random.default_rng(S * T + window + K)
    qn = rng.standard_normal((B, S, H, DN + DR), np.float32) * qscale
    kn = rng.standard_normal((B, T, K, DN + DR), np.float32)
    vn = rng.standard_normal((B, T, K, DV), np.float32)
    q, k, v = (torch.as_tensor(a).to(dtype) for a in (qn, kn, vn))
    emu32 = emulate_tc(q, k, v, causal=causal, window=window)
    assert emu32.shape == (B, S, H, DV)
    ref32 = ops.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal, window=window)
    W = _weights_times_abs_v(q, k, v, causal, window)
    slack = 2.0 ** -13 * W + 1e-6
    exact = emulate_tc(q, k, v, causal=causal, window=window, round_p=False)
    assert ((exact - ref32).abs().double() <= slack).all()
    assert ((emu32 - ref32).abs().double()
            <= ops.UNIT_ROUNDOFF[dtype] * W + slack).all()
    ref = ops.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(emu32.to(dtype).float(), ref.float(),
                               **ops.tolerance("flash_tc", dtype, v))
