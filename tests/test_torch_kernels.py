"""The port's kernel modules on the CPU: each plain version (what the
wrapper runs for CPU tensors) against the reference's Pallas kernel in
interpret mode, on the same numpy inputs.  Scores are quantized to
quarters, so exact ties are common and the tie order is exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.epoch_persistent.ops import persistent_epoch as pallas_epoch
from repro.kernels.psdsf_score.ops import masked_argmin1d, masked_argmin2d
from repro_torch.core import engine_torch
from repro_torch.kernels.epoch_persistent.ops import persistent_epoch
from repro_torch.kernels.psdsf_score import ops as tiles


def _scores(rng, shape):
    return (np.round(rng.standard_normal(shape) * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("N", [1, 7, 128, 300, 1000])
def test_masked_argmin1d_plain_equals_pallas(N):
    rng = np.random.default_rng(N)
    s = _scores(rng, N)
    for ok in (rng.random(N) < 0.6, np.zeros(N, bool)):
        v1, i1 = masked_argmin1d(jnp.asarray(s), jnp.asarray(ok),
                                 interpret=True)
        v2, i2 = tiles.masked_argmin1d(torch.as_tensor(s),
                                       torch.as_tensor(ok))
        assert int(i2) == int(i1)
        assert float(v2) == float(v1)


@pytest.mark.parametrize("N,J", [(3, 2), (64, 64), (130, 129), (256, 128),
                                 (9, 300)])
def test_masked_argmin2d_plain_equals_pallas(N, J):
    """Index included: exact ties across tiles resolve in tile order."""
    rng = np.random.default_rng(N * J)
    s = _scores(rng, (N, J))
    for feas in (rng.random((N, J)) < 0.5, np.zeros((N, J), bool)):
        v1, n1, j1 = masked_argmin2d(jnp.asarray(s), jnp.asarray(feas),
                                     interpret=True)
        v2, n2, j2 = tiles.masked_argmin2d(torch.as_tensor(s),
                                           torch.as_tensor(feas))
        assert (int(n2), int(j2)) == (int(n1), int(j1))
        assert float(v2) == float(v1)


def test_masked_argmin2d_tile_order_differs_from_lexicographic():
    """The case the tile order exists for: (0, 200) comes first in (n, j)
    order, but its tile (0, 1) comes after the tile (0, 0) of (1, 3)."""
    s = np.ones((2, 256), np.float32)
    s[0, 200] = s[1, 3] = 0.0
    feas = np.ones((2, 256), bool)
    _v, n, j = tiles.masked_argmin2d(torch.as_tensor(s),
                                     torch.as_tensor(feas))
    assert (int(n), int(j)) == (1, 3)
    _v, n1, j1 = masked_argmin2d(jnp.asarray(s), jnp.asarray(feas),
                                 interpret=True)
    assert (int(n1), int(j1)) == (1, 3)


def _quantized(seed, N=13, J=11, R=2):
    rng = np.random.default_rng(seed)
    D = 2.0 ** rng.integers(-2, 2, (N, R))
    C = rng.integers(4, 12, (J, R)).astype(np.float64)
    return dict(X=np.zeros((N, J)), D=D, TD=D, C=C, FREE=C.copy(),
                phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
                wanted=rng.integers(1, 6, N).astype(np.float64),
                allowed=rng.random((N, J)) > 0.2)


SEEDS = {"drf": 0, "tsf": 2, "psdsf": 4, "rpsdsf": 6}


@pytest.mark.parametrize("crit", list(SEEDS))
@pytest.mark.parametrize("pol", ["pooled", "rrr"])
def test_persistent_epoch_plain_equals_pallas(crit, pol):
    """K3's plain version and the reference's persistent Pallas kernel,
    from one initial state: every returned array equal."""
    k = _quantized(SEEDS[crit] + (pol == "rrr"))
    J = k["C"].shape[0]
    perms = np.stack([np.random.default_rng(3).permutation(J)
                      for _ in range(8)]).astype(np.int32)
    limit = 2 if crit in ("drf", "rpsdsf") else 0
    t = {n: torch.as_tensor(v) for n, v in k.items()}
    state = engine_torch.epoch_state(
        t["X"], t["D"], t["TD"], t["C"], t["FREE"], t["phi"], t["wanted"],
        t["allowed"], torch.as_tensor(perms),
        torch.zeros(J, dtype=torch.int32), 0, 0, J, limit, 1e-9, kind=crit,
        lookahead=False,
        use_limit=bool(limit))
    kw = dict(kind=crit, policy=pol, lookahead=False, use_limit=bool(limit),
              max_steps=64)
    # copies, and a blocking read: the plain version updates ``state`` in
    # place, and JAX on the CPU may alias numpy memory while it runs
    want = jax.block_until_ready(pallas_epoch(
        *(jnp.array(a.numpy()) if torch.is_tensor(a) else a for a in state),
        interpret=True, **kw))
    got = persistent_epoch(*state, **kw)
    assert 0 < int(got[2]) < 64
    for a, b, name in zip(got, want,
                          "ns js count X tot FREE used pidx pos".split()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{crit}/{pol}/{name}")
