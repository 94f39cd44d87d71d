"""The port's epoch engine against the reference's, bit for bit: the same
numpy instance and rng seed through ``engine_jax.run_epoch`` and
``engine_torch.run_epoch(device="cpu")`` give the same grant sequence, and
the two rng streams end in the same state.

``kernel=None`` / ``"persistent"`` / ``"tiles"`` stand against
``use_pallas=False`` / ``"persistent"`` / ``True``; on the CPU the port
runs each kernel's plain version and the reference its Pallas kernel in
interpret mode.  Instances are quantized (power-of-two demands, integer
capacities) so the order-dependent sums (the rPS-DSF residual, the TSF
monopoly) are exact on both sides."""
import numpy as np
import pytest

from repro.core import engine_jax as ej
from repro_torch.core import engine_torch as et

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("pooled", "rrr")
KERNELS = ((None, False), ("persistent", "persistent"), ("tiles", True))


def _instance(seed, N=6, J=7, R=2):
    """phi != 1, placement constraints, one framework that wants a single
    executor (mid-epoch exhaustion of `wanted`)."""
    rng = np.random.default_rng(seed)
    D = 2.0 ** rng.integers(-2, 2, (N, R))
    C = rng.integers(4, 13, (J, R)).astype(np.float64)
    allowed = rng.random((N, J)) > 0.25
    allowed[:, 0] = True
    wanted = rng.integers(3, 9, N).astype(np.float64)
    wanted[-1] = 1.0
    return dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
                phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
                allowed=allowed, wanted=wanted, true_demands=D)


def _both(crit, pol, kernel, use_pallas, kw, seed=7, **extra):
    r_ref, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    want = ej.run_epoch(crit, pol, rng=r_ref, use_pallas=use_pallas, **kw,
                        **extra)
    got = et.run_epoch(crit, pol, rng=r_port, kernel=kernel, device="cpu",
                       **kw, **extra)
    assert r_port.bit_generator.state == r_ref.bit_generator.state
    return got, want


@pytest.mark.parametrize("kernel,use_pallas", KERNELS,
                         ids=["plain", "persistent", "tiles"])
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_grants_equal_reference(crit, pol, kernel, use_pallas):
    kw = _instance(3)
    for limit in (None, 2):
        got, want = _both(crit, pol, kernel, use_pallas, kw,
                          per_agent_limit=limit)
        assert got == want, f"limit={limit}"
        assert 0 < len(got)
        if limit is not None:
            assert np.bincount([j for _n, j in got]).max() <= limit
        # the single-executor framework stopped after one grant
        assert sum(n == len(kw["phi"]) - 1 for n, _j in got) <= 1


def test_helpers_match_reference():
    TD = np.zeros((1, 2))
    FREE = np.ones((3, 2)) * 8.0
    for args, limit in (((TD, FREE, np.zeros(1), np.array([5.0])), None),
                        ((TD, FREE, np.zeros(1), np.array([1e6])), 2)):
        assert (et.grant_bound(*args, per_agent_limit=limit)
                == ej.grant_bound(*args, per_agent_limit=limit))
    for bound, J in ((1, 8), (100, 7), (5000, 64), (10**6, 3)):
        assert et.rrr_perm_budget(bound, J) == ej.rrr_perm_budget(bound, J)
        assert et._bucket(bound) == ej._bucket(bound)


def test_async_handle_is_the_commit_point():
    kw = _instance(19)
    handle = et.run_epoch_async("rpsdsf", "rrr", rng=np.random.default_rng(3),
                                device="cpu", **kw)
    assert handle.in_flight
    seq = handle.result()
    assert not handle.in_flight and handle.result() is seq
    assert seq == et.run_epoch("rpsdsf", "rrr", rng=np.random.default_rng(3),
                               device="cpu", **kw)
