"""K5's plain version (the port's flash attention on the CPU) against the
reference's Pallas kernel in interpret mode and its closed form
``attention_ref``, with the tolerances of tests/test_kernels.py: 2e-5 for
f32, 5e-2 for bf16 (the output is rounded to q's type).  The same numpy
inputs go to both packages.  The kernel itself is held against this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import ops

SHAPES = [
    (2, 4, 2, 64, 64, 16, True, 0),      # GQA causal
    (1, 4, 4, 128, 128, 32, True, 0),    # MHA
    (2, 6, 2, 64, 64, 16, True, 24),     # sliding window
    (2, 6, 3, 96, 96, 16, True, 17),     # odd window, 3-way GQA
    (1, 2, 1, 64, 128, 16, False, 0),    # non-causal, T != S
    (1, 8, 1, 32, 32, 64, True, 0),      # MQA
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}


def _inputs(seed, B, H, K, S, T, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, T, K, D), np.float32),
            rng.standard_normal((B, T, K, D), np.float32))


def _ref_closed_form(q, k, v, causal, window):
    t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    return t(attention_ref(t(q), t(k), t(v), causal=causal, window=window))


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_and_ref(B, H, K, S, T, D, causal, window,
                                      dtype):
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(S + T + H + D, B, H, K, S, T, D)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                              causal=causal, window=window)
    assert ops.flash_attention.launches == n0      # the CPU launches nothing
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    pallas = pallas_flash(jq, jk, jv, causal=causal, window=window, bq=32,
                          bk=32, interpret=True)
    ref = _ref_closed_form(jq, jk, jv, causal, window)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=atol)


def test_matches_model_layer_gemma3():
    """The port's attention seam (K5's plain version on the CPU) == the
    reference model's XLA attention (mask semantics), gemma3's window on a
    local layer, as tests/test_kernels.py holds the Pallas kernel."""
    from repro.configs import get_config
    from repro.nn.layers import _gqa_scores_softmax_out, causal_window_mask
    from repro_torch.configs import get_config as port_config
    from repro_torch.nn.layers import attention_core

    cfg = get_config("gemma3_12b", smoke=True)
    B, S, H, K, D = 2, 32, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _inputs(5, B, H, K, S, S, D)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    mask = causal_window_mask(pos, pos, cfg.window, jnp.array(False))
    xla = _gqa_scores_softmax_out(cfg, jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mask[:, None, None])
    got = attention_core(port_config("gemma3_12b", smoke=True),
                         *(torch.as_tensor(a) for a in (q, k, v)),
                         is_global=False)
    np.testing.assert_allclose(_f32(got), np.asarray(xla), atol=3e-5)
    pallas = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                          window=cfg.window, bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(_f32(got), np.asarray(pallas), atol=3e-5)


@pytest.mark.parametrize("window", [3, 5, 15])
def test_window_below_the_tile(window):
    """A window smaller than the key tile: rows of later query tiles see no
    valid key in their first tiles.  Equal to the Pallas kernel (tiles of
    16) and to the closed form."""
    q, k, v = _inputs(window, 1, 4, 2, 64, 64, 16)
    got = ops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                              causal=True, window=window)
    j = [jnp.asarray(a) for a in (q, k, v)]
    pallas = pallas_flash(*j, causal=True, window=window, bq=16, bk=16,
                          interpret=True)
    np.testing.assert_allclose(_f32(got), np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(
        _f32(got), np.asarray(_ref_closed_form(*j, True, window)), atol=2e-5)


@pytest.mark.parametrize("B,H,K,S,T,D,causal,window", [
    (2, 4, 2, 50, 50, 16, True, 0),      # ragged S, causal
    (1, 6, 3, 77, 77, 32, True, 9),      # ragged S, window
    (2, 2, 1, 37, 53, 16, False, 0),     # ragged, non-causal, T != S
    (1, 4, 2, 1, 1, 64, True, 0),        # one token
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_against_closed_form(B, H, K, S, T, D, causal, window, dtype):
    """Any S and T (the Pallas kernel needs multiples of its tiles)."""
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v = _inputs(S * T, B, H, K, S, T, D)
    got = ops.flash_attention(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)),
                              causal=causal, window=window)
    ref = _ref_closed_form(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal,
                           window)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=atol)


def test_row_with_no_valid_key_gives_zero():
    """Non-causal with a window and T < S: the last queries see no key at
    all and give 0, as ``attention_ref`` states."""
    q, k, v = _inputs(1, 1, 2, 1, 48, 16, 16)
    got = _f32(ops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                   causal=False, window=4))
    ref = _ref_closed_form(*(jnp.asarray(a) for a in (q, k, v)), False, 4)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5)
    assert (got[:, 19:] == 0).all() and (np.abs(got[:, :19]) > 0).any()
