"""K6's three-phase algorithm on the CPU: an emulation of ``csrc/wkv6.cu``
(every chunk's own part at once, the scan of the state over the chunks,
every chunk's inter-chunk part at once; ``ref.wkv6_three_phase``) held
against K6's plain version ``wkv6_ref`` (output and final state, from
``state0`` too, with a ragged tail) and against the reference's Pallas
``wkv6_bhsd`` in interpret mode (S a multiple of the chunk, u expanded per
stream, zero initial state: what that kernel takes).

Tolerances, as tests/test_torch_wkv6.py and the card's: ``WKV_TOL`` (rtol
1e-4, atol 1e-4) where outputs stay O(1-10) and only the order of f32 sums
differs (the scores' sums over channels, the state's sum over chunks);
``WKV_TOL_STRONG`` (rtol 1e-3, atol 2e-3) under strong decay, where the
outputs reach ~1e2 and the exponents are differences of cumulative
log-decays near -1e3 to -1e4 (both versions sum those in token order: in
another order one rounding moves an exponent by ~1e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.kernel import wkv6_bhsd
from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_three_phase

WKV_TOL = dict(rtol=1e-4, atol=1e-4)
WKV_TOL_STRONG = dict(rtol=1e-3, atol=2e-3)


def _inputs(seed, B, S, H, D, strong=False):
    rng = np.random.default_rng(seed)
    scale = 1.0 if strong else 0.5
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) * scale
               for _ in range(3))
    z = rng.standard_normal((B, S, H, D)).astype(np.float32)
    lw = -np.exp(z * 2.0 + 2.0 if strong else z * 0.5).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * scale
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return [torch.as_tensor(a) for a in (r, k, v, lw, u)], torch.as_tensor(s0)


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (2, 128, 3, 16, 32, False),    # whole chunks
    (1, 70, 2, 16, 32, False),     # a ragged tail
    (2, 100, 2, 40, 48, False),    # D not a power of two, chunk 48
    (1, 37, 2, 8, 64, False),      # one partial chunk
    (1, 96, 2, 8, 32, True),       # strong decay
    (1, 75, 3, 16, 16, True),      # strong decay, ragged
    (1, 5, 1, 4, 3, False)])       # a chunk of three tokens
def test_three_phase_equals_plain(B, S, H, D, chunk, strong, with_state0):
    args, s0 = _inputs(B * S + D, B, S, H, D, strong)
    state0 = s0 if with_state0 else None
    y, s = wkv6_three_phase(*args, chunk=chunk, state0=state0)
    yr, sr = wkv6_ref(*args, chunk=chunk, state0=state0)
    tol = WKV_TOL_STRONG if strong else WKV_TOL
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, **tol)
    torch.testing.assert_close(s, sr, **tol)


@pytest.mark.parametrize("B,S,H,D,chunk,strong", [
    (2, 128, 3, 16, 32, False), (1, 64, 4, 32, 64, False),
    (1, 96, 2, 8, 32, True)])
def test_three_phase_equals_pallas(B, S, H, D, chunk, strong):
    args, _ = _inputs(S + H, B, S, H, D, strong)
    y, _ = wkv6_three_phase(*args, chunk=chunk)
    r, k, v, lw, u = (a.numpy() for a in args)

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    want = wkv6_bhsd(bhsd(r), bhsd(k), bhsd(v), bhsd(lw),
                     jnp.asarray(np.tile(u, (B, 1))), chunk=chunk,
                     interpret=True)
    want = np.asarray(want).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    tol = WKV_TOL_STRONG if strong else WKV_TOL
    np.testing.assert_allclose(y.numpy(), want, **tol)
