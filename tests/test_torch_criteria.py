"""The port's criterion module against the reference's: in float64 the
``xp=torch`` path equals the numpy path, in float32 it equals the
``xp=jax.numpy`` path.  Instances are quantized (power-of-two demands,
integer capacities) so every sum is exact whatever its order: the TSF
monopoly sum over agents is the one order-dependent reduction."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import criteria as ref
from repro_torch.core import criteria as port

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")


def _instance(seed, N=6, J=9, R=3):
    rng = np.random.default_rng(seed)
    return dict(
        X=rng.integers(0, 4, (N, J)).astype(np.float64),
        D=2.0 ** rng.integers(-2, 2, (N, R)),
        C=rng.integers(2, 17, (J, R)).astype(np.float64),
        phi=np.array([0.5, 1.0, 2.0])[np.arange(N) % 3],
        allowed=rng.random((N, J)) > 0.3,
    )


def _torch(a, dtype):
    t = torch.as_tensor(a)
    return t if t.dtype == torch.bool else t.to(dtype)


def _jnp(a):
    return jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("crit", CRITERIA)
def test_scores_f64_equal_numpy(crit, seed):
    k = _instance(seed)
    for lookahead in (False, True):
        want = ref.criterion_scores(crit, k["X"], k["D"], k["C"], k["phi"],
                                    lookahead=lookahead, allowed=k["allowed"])
        got = port.criterion_scores(
            crit, *(_torch(k[n], torch.float64) for n in ("X", "D", "C",
                                                          "phi")),
            lookahead=lookahead, xp=torch,
            allowed=_torch(k["allowed"], torch.float64))
        np.testing.assert_array_equal(got.numpy(), want)
        # the port's numpy path is the reference's
        np.testing.assert_array_equal(
            port.criterion_scores(crit, k["X"], k["D"], k["C"], k["phi"],
                                  lookahead=lookahead, allowed=k["allowed"]),
            want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("crit", CRITERIA)
def test_scores_f32_equal_jax(crit, seed):
    k = _instance(seed)
    want = ref.criterion_scores(crit, *(_jnp(k[n]) for n in ("X", "D", "C",
                                                             "phi")),
                                lookahead=False, xp=jnp,
                                allowed=_jnp(k["allowed"]))
    got = port.criterion_scores(
        crit, *(_torch(k[n], torch.float32) for n in ("X", "D", "C", "phi")),
        lookahead=False, xp=torch, allowed=_torch(k["allowed"], None))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_building_blocks_f32_equal_jax(seed):
    k = _instance(seed)
    k["C"][0, 1] = 0.0          # an exhausted residual: the BIG branch
    t = {n: _torch(v, torch.float32) for n, v in k.items()}
    j = {n: _jnp(v) for n, v in k.items()}
    pairs = [
        (port.drf_dominant(t["D"], t["C"], xp=torch),
         ref.drf_dominant(j["D"], j["C"], xp=jnp)),
        (port.tsf_monopoly(t["D"], t["C"], allowed=t["allowed"], xp=torch),
         ref.tsf_monopoly(j["D"], j["C"], allowed=j["allowed"], xp=jnp)),
        (port.virtual_dominant(t["D"], t["C"], xp=torch),
         ref.virtual_dominant(j["D"], j["C"], xp=jnp)),
        (port.residual_capacities(t["X"], t["D"], t["C"], xp=torch),
         ref.residual_capacities(j["X"], j["D"], j["C"], xp=jnp)),
        (port.usage_dominant_share(t["X"][:, :3], t["C"][:3].T, t["phi"],
                                   xp=torch),
         ref.usage_dominant_share(j["X"][:, :3], j["C"][:3].T, j["phi"],
                                  xp=jnp)),
        (port.fair_share_level(t["phi"], xp=torch),
         ref.fair_share_level(j["phi"], xp=jnp)),
        (port.feasible_mask(t["D"], t["C"], t["allowed"],
                            t["phi"] > 0.7, xp=torch),
         ref.feasible_mask(j["D"], j["C"], j["allowed"], j["phi"] > 0.7,
                           xp=jnp)),
    ]
    for metric in ("cosine", "align", "tasks", "tight", "slack"):
        pairs.append((port.bestfit_scores(t["C"], t["D"][0], metric=metric,
                                          xp=torch),
                      ref.bestfit_scores(j["C"], j["D"][0], metric=metric,
                                         xp=jnp)))
    for got, want in pairs:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
