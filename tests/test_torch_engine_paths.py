"""The port's epoch engine against the reference's on the paths around the
loop: chained segments, RRR permutation growth, sharded selects, shapes
wider than one 128-wide tile, and every array the loop returns.  Same
conventions as tests/test_torch_engine.py (quantized instances, numpy
inputs through both packages)."""
import numpy as np
import pytest
import torch

from repro.core import engine_jax as ej
from repro_torch.core import engine_torch as et
from test_torch_engine import CRITERIA, KERNELS, POLICIES, _both, _instance


@pytest.mark.parametrize("kernel,use_pallas", KERNELS,
                         ids=["plain", "persistent", "tiles"])
def test_chaining_and_permutation_growth(kernel, use_pallas):
    """A small max_steps_cap chains segments (RRR cursor carried across);
    a two-row permutation stack grows by stream-append and replays."""
    kw = _instance(5, N=3, J=4)
    kw["wanted"] = np.full(3, 1e6)
    seqs = set()
    for extra in ({}, {"max_steps_cap": 16},
                  {"max_steps_cap": 16, "_perm_rows": 2}):
        got, want = _both("rpsdsf", "rrr", kernel, use_pallas, kw, **extra)
        assert got == want, extra
        seqs.add(tuple(got))
    assert len(seqs) == 1 and len(got) > 16


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("crit,pol", [("psdsf", "pooled"), ("drf", "pooled"),
                                      ("rpsdsf", "rrr")])
def test_sharded_selects(crit, pol, shards):
    kw = _instance(11, N=8, J=8)
    got, want = _both(crit, pol, None, False, kw, shards=shards,
                      per_agent_limit=3)
    assert got == want
    unsharded, _ = _both(crit, pol, None, False, kw, per_agent_limit=3)
    assert got == unsharded


@pytest.mark.parametrize("crit,pol", [("psdsf", "pooled"),
                                      ("rpsdsf", "pooled"), ("drf", "rrr")])
def test_wider_than_a_tile(crit, pol):
    """J = 200 agents pad to 256: two 128-wide column tiles, identical
    agents, so exact ties straddle the tile boundary."""
    kw = _instance(13, N=4, J=200)
    kw["C"][:] = (8.0, 8.0)
    kw["FREE"] = kw["C"].copy()
    kw["allowed"][:] = True
    for kernel, use_pallas in KERNELS:
        got, want = _both(crit, pol, kernel, use_pallas, kw,
                          per_agent_limit=1)
        assert got == want, kernel


def test_epoch_loop_returns_reference_state():
    """Every array the loop returns (sequence, count, X, tot, FREE, used,
    RRR cursor) equals the reference loop's, for each kernel."""
    import jax.numpy as jnp

    kw = _instance(17, N=8, J=8)
    J = 8
    perms = np.stack([np.random.default_rng(1).permutation(J)
                      for _ in range(8)]).astype(np.int32)
    raw = (kw["X"], kw["D"], kw["true_demands"], kw["C"], kw["FREE"],
           kw["phi"], kw["wanted"], kw["allowed"], perms,
           np.zeros(J, np.int32))
    tail = (0, 0, J, 2, 1e-9)
    for crit in CRITERIA:
        for pol in POLICIES:
            stat = dict(kind=crit, policy=pol, lookahead=False,
                        use_limit=True, max_steps=64)
            want = ej._jitted(False)(
                *(jnp.asarray(a, jnp.float32) if a.dtype == np.float64
                  else jnp.asarray(a) for a in raw),
                np.int32(0), np.int32(0), jnp.int32(J), np.int32(2),
                jnp.float32(1e-9), use_pallas=False, interpret=True,
                shards=1, **stat)
            for kernel in ("persistent", "tiles", None):
                got = et.epoch_loop(*(torch.as_tensor(a) for a in raw),
                                    *tail, kernel=kernel, **stat)
                for a, b, name in zip(got, want, "ns js count X tot FREE "
                                      "used pidx pos".split()):
                    np.testing.assert_array_equal(
                        np.asarray(a), np.asarray(b),
                        err_msg=f"{crit}/{pol}/{kernel}/{name}")
