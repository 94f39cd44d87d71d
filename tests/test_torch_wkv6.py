"""K6's plain version (the port's WKV6 on the CPU) against the reference's
Pallas kernel in interpret mode and its chunked XLA twin, with the
tolerances of tests/test_kernels.py: atol 1e-4, and rtol 1e-3 / atol 2e-3
under strong decay (outputs reach ~1e2).  The final state, which the
prefill keeps for the decode, is held against ``wkv6_chunked``'s.  Inputs
are made with numpy and given to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6
from repro.nn.ssm import wkv6_chunked, wkv6_scan as ref_scan
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_scan


def _inputs(seed, B, S, H, D, scale=0.5, decay_scale=0.5, shift=0.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D), np.float32) * scale
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 * decay_scale + shift)
    u = rng.standard_normal((H, D)).astype(np.float32) * scale
    return r, k, v, lw.astype(np.float32), u


def _port(args, **kw):
    return ops.wkv6(*(torch.as_tensor(a) for a in args), **kw)


@pytest.mark.parametrize("B,S,H,D,chunk", [
    (2, 128, 3, 16, 32), (1, 96, 2, 8, 32), (2, 70, 2, 16, 32),
    (1, 64, 4, 32, 64)])
def test_plain_matches_pallas_and_chunked(B, S, H, D, chunk):
    args = _inputs(B * S + H, B, S, H, D)
    n0 = ops.wkv6.launches
    y, s_end = _port(args, chunk=chunk)
    assert ops.wkv6.launches == n0      # the CPU launches nothing
    assert y.dtype == s_end.dtype == torch.float32
    assert y.shape == (B, S, H, D) and s_end.shape == (B, H, D, D)
    j = [jnp.asarray(a) for a in args]
    pallas = pallas_wkv6(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), atol=1e-4)
    y2, s2 = wkv6_chunked(*j, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y2), atol=1e-4)
    np.testing.assert_allclose(s_end.numpy(), np.asarray(s2), atol=1e-4)


@pytest.mark.parametrize("S", [1, 5, 64, 70])
def test_scan_matches_reference_scan(S):
    """The exact recurrence (the decode step) and the chunked plain version
    against the reference's ``wkv6_scan``, from a given state."""
    B, H, D = 2, 2, 16
    args = _inputs(S, B, S, H, D)
    s0 = np.random.default_rng(9).standard_normal((B, H, D, D)).astype(
        np.float32)
    y, s = wkv6_scan(*(torch.as_tensor(a) for a in args), torch.as_tensor(s0))
    yr, sr = ref_scan(*(jnp.asarray(a) for a in args), jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-5)
    yc, sc = _port(args, chunk=32, state0=torch.as_tensor(s0))
    np.testing.assert_allclose(yc.numpy(), np.asarray(yr), atol=1e-4)
    np.testing.assert_allclose(sc.numpy(), np.asarray(sr), atol=1e-4)


@pytest.mark.parametrize("s,decay_scale,seed", [
    (2, 0.1, 0), (3, 1.0, 7), (5, 2.0, 13), (4, 1.5, 50)])
def test_strong_decay_finite_and_matches(s, decay_scale, seed):
    """Log-decays near -exp(2 +- 2 sigma): every exponent stays <= 0, so the
    output is finite and matches the Pallas kernel and the exact scan."""
    B, H, D = 1, 2, 8
    S = 32 * s
    args = _inputs(seed, B, S, H, D, scale=1.0, decay_scale=decay_scale,
                   shift=2.0)
    y, s_end = _port(args, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(s_end).all()
    j = [jnp.asarray(a) for a in args]
    pallas = pallas_wkv6(*j, chunk=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(pallas), rtol=1e-3,
                               atol=2e-3)
    yr, sr = ref_scan(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(s_end.numpy(), np.asarray(sr), rtol=1e-3,
                               atol=2e-3)
