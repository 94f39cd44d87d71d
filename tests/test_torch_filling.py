"""The port's progressive filling (``repro_torch.core.filling_torch``)
against the reference's device engine (``repro.core.filling_jax``, jitted
on the CPU) and against the exact numpy filler, on the same instances.

Deterministic configurations agree bit for bit (exact equality of the
int32 allocations).  RRR draws from other generators than the reference,
so there the trial means are held within ``atol=0.8`` tasks a cell, the
tolerance of the reference's own JAX-vs-numpy test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.filling import FillConfig, progressive_fill
from repro.core.filling_jax import fill_trials_jax, progressive_fill_jax
from repro.core.instance import (
    make_instance,
    paper_example,
    spark_cluster_fig9,
    spark_cluster_heterogeneous,
)
from repro_torch.core import engine_torch, filling_torch
from repro_torch.core.filling_torch import (
    fill_trials_torch,
    progressive_fill_torch,
    trial_generators,
)

RRR_ATOL = 0.8


def _instances():
    return {
        "paper": paper_example(),
        "weighted": make_instance(
            demands=[[2.0, 2.0], [1.0, 3.5], [1.0, 1.0]],
            capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0]],
            weights=[2.0, 1.0, 0.5],
        ),
        "constrained": make_instance(
            demands=[[2.0, 2.0], [1.0, 3.5]],
            capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0]],
            weights=[1.0, 2.0],
            allowed=[[True, True, False], [True, True, True]],
        ),
    }


def _allowed(inst):
    return None if inst.allowed.all() else inst.allowed


def _jax_fill(inst, key=0, **kw):
    al = _allowed(inst)
    return np.asarray(progressive_fill_jax(
        jnp.asarray(inst.demands, jnp.float32),
        jnp.asarray(inst.capacities, jnp.float32),
        jnp.asarray(inst.weights, jnp.float32), jax.random.key(key),
        allowed=None if al is None else jnp.asarray(al), **kw))


def _torch_args(inst):
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return t(inst.demands), t(inst.capacities), t(inst.weights)


def _torch_fill(inst, generator=None, **kw):
    al = _allowed(inst)
    x = progressive_fill_torch(
        *_torch_args(inst), generator,
        allowed=None if al is None else torch.as_tensor(al), **kw)
    assert x.dtype == torch.int32 and x.device.type == "cpu"
    return x.numpy()


def _numpy_fill(inst, crit, pol, tie="low", seed=0):
    return progressive_fill(inst, FillConfig(
        criterion=crit, server_policy=pol, lookahead=False, tie=tie),
        seed=seed).x


DETERMINISTIC = (
    [("paper", c, p) for c, p in (("psdsf", "pooled"), ("rpsdsf", "pooled"),
                                  ("drf", "bestfit"), ("tsf", "pooled"))]
    + [(name, c, p) for name in ("weighted", "constrained")
       for c in ("drf", "tsf", "psdsf", "rpsdsf")
       for p in ("pooled", "bestfit")])


@pytest.mark.parametrize("name,crit,pol", DETERMINISTIC)
def test_deterministic_equals_jax_and_numpy(name, crit, pol):
    """Bit for bit: the pooled path through the epoch loop (K3's plain
    version on the CPU), best-fit through the step loop."""
    inst = _instances()[name]
    kw = dict(criterion=crit, policy=pol, lookahead=False, tie="low")
    got = _torch_fill(inst, **kw)
    np.testing.assert_array_equal(got, _jax_fill(inst, **kw))
    np.testing.assert_array_equal(got, _numpy_fill(inst, crit, pol))


@pytest.mark.parametrize("crit", ["drf", "psdsf"])
def test_rrr_distributional_agreement(crit):
    """Trial means over 150 trials within ``RRR_ATOL`` of the reference's
    (other draws) and of the numpy filler's."""
    inst = paper_example()
    kw = dict(criterion=crit, policy="rrr", lookahead=False, tie="random")
    xt = fill_trials_torch(*_torch_args(inst), 150,
                           generator=torch.Generator().manual_seed(11),
                           **kw).numpy()
    assert xt.shape == (150, 2, 2) and xt.dtype == np.int32
    keys = jax.random.split(jax.random.key(11), 150)
    xj = np.asarray(fill_trials_jax(*(jnp.asarray(a, jnp.float32) for a in (
        inst.demands, inst.capacities, inst.weights)), keys, **kw))
    xn = np.stack([_numpy_fill(inst, crit, "rrr", "random", s)
                   for s in range(150)])
    np.testing.assert_allclose(xt.mean(0), xj.mean(0), atol=RRR_ATOL)
    np.testing.assert_allclose(xt.mean(0), xn.mean(0), atol=RRR_ATOL)
    # every trial fills to exhaustion
    for x in xt:
        assert not inst.feasible(x).any()


@pytest.mark.parametrize("crit,pol,tie", [
    ("rpsdsf", "pooled", "low"), ("drf", "rrr", "random"),
    ("psdsf", "pooled", "random"), ("tsf", "bestfit", "random")])
def test_saturates(crit, pol, tie):
    """The fill ends because nothing fits anywhere, never overcommitting
    a server beyond the f32 slack."""
    inst = make_instance([[2, 1], [1, 3]], [[9, 7], [5, 12], [8, 8]])
    x = _torch_fill(inst, torch.Generator().manual_seed(3), criterion=crit,
                    policy=pol, tie=tie)
    assert not inst.feasible(x).any()
    assert (inst.residual(x) >= -1e-4).all()


@pytest.mark.parametrize("pol,tie", [("pooled", "low"), ("rrr", "random"),
                                     ("bestfit", "low")])
def test_warm_start(pol, tie):
    """``x0`` warm start: the fill resumes from an existing allocation and
    never takes a task away; the deterministic ones equal the reference."""
    inst = paper_example()
    x0 = np.array([[5, 0], [0, 5]], np.int32)
    kw = dict(criterion="rpsdsf", policy=pol, tie=tie)
    x = _torch_fill(inst, torch.Generator().manual_seed(0),
                    x0=torch.as_tensor(x0), **kw)
    assert (x >= x0).all()
    assert not inst.feasible(x).any()
    if tie == "low":
        np.testing.assert_array_equal(x, _jax_fill(inst, x0=jnp.asarray(x0),
                                                   **kw))


@pytest.mark.parametrize("crit", ["psdsf", "rpsdsf"])
def test_sharded_parity(crit, monkeypatch):
    """``shards`` is passed to the epoch loop and changes no allocation
    (the counterpart of the reference's sharded filling parity)."""
    seen = []
    loop = engine_torch.epoch_loop

    def spy(*a, **k):
        seen.append(k["shards"])
        return loop(*a, **k)

    monkeypatch.setattr(engine_torch, "epoch_loop", spy)
    inst = spark_cluster_heterogeneous()
    kw = dict(criterion=crit, policy="pooled", tie="low")
    base = _torch_fill(inst, **kw)
    np.testing.assert_array_equal(_torch_fill(inst, shards=2, **kw), base)
    np.testing.assert_array_equal(_jax_fill(inst, shards=2, **kw), base)
    assert seen == [1, 2]


@pytest.mark.parametrize("inst_fn,J", [(spark_cluster_fig9, 3),
                                       (spark_cluster_heterogeneous, 6)])
@pytest.mark.parametrize("crit", ["drf", "tsf", "psdsf", "rpsdsf"])
def test_servers_padded_to_a_multiple_of_four(inst_fn, J, crit, monkeypatch):
    """J % 4 != 0: the epoch loop sees J padded with zero-capacity servers
    that are not allowed, and the cropped result equals the reference."""
    seen = []
    loop = engine_torch.epoch_loop

    def spy(X, *a, **k):
        seen.append((tuple(X.shape), a[6].clone()))    # allowed
        return loop(X, *a, **k)

    monkeypatch.setattr(engine_torch, "epoch_loop", spy)
    inst = inst_fn()
    kw = dict(criterion=crit, policy="pooled", tie="low")
    got = _torch_fill(inst, **kw)
    (shape, allowed), = seen
    Jp = -(-J // 4) * 4
    assert shape == (inst.n_frameworks, Jp) and Jp > J
    assert allowed[:, :J].all() and not allowed[:, J:].any()
    assert got.shape == (inst.n_frameworks, J)
    np.testing.assert_array_equal(got, _jax_fill(inst, **kw))
    np.testing.assert_array_equal(got, _numpy_fill(inst, crit, "pooled"))


@pytest.mark.parametrize("crit,pol,tie", [
    ("drf", "rrr", "random"), ("rpsdsf", "rrr", "low"),
    ("psdsf", "pooled", "random"), ("drf", "bestfit", "random")])
def test_batch_equals_trials_one_by_one(crit, pol, tie, monkeypatch):
    """A batch whose trials end at different steps equals each trial run
    alone on the same generator: a finished trial is frozen."""
    inst = make_instance([[2, 1], [1, 3], [3, 1]], [[9, 7], [5, 12], [8, 8],
                                                    [3, 4], [6, 2]])
    monkeypatch.setattr(filling_torch, "ALIVE_EVERY", 3)
    kw = dict(criterion=crit, policy=pol, tie=tie)
    batch = fill_trials_torch(*_torch_args(inst), 12,
                              generator=torch.Generator().manual_seed(5),
                              **kw)
    gens = trial_generators(torch.Generator().manual_seed(5), 12, "cpu")
    alone = torch.stack([progressive_fill_torch(*_torch_args(inst), g, **kw)
                         for g in gens])
    assert torch.equal(batch, alone)
    steps = batch.sum((1, 2))
    assert len(set(steps.tolist())) > 1, "every trial ended at one step"
    for x in batch.numpy():
        assert not inst.feasible(x).any()


def test_deterministic_trials_are_one_fill_broadcast():
    inst = paper_example()
    kw = dict(criterion="psdsf", policy="pooled", tie="low")
    x = fill_trials_torch(*_torch_args(inst), 5, **kw)
    assert x.shape == (5, 2, 2)
    for xi in x:
        np.testing.assert_array_equal(xi.numpy(), _torch_fill(inst, **kw))
    np.testing.assert_array_equal(x[0].numpy(), [[19, 0], [2, 20]])


def test_rrr_rpsdsf_every_trial_is_the_claim():
    """``filling.py``'s claim: RRR-rPS-DSF == rPS-DSF, (19, 2, 2, 19), in
    every one of 200 trials."""
    x = fill_trials_torch(*_torch_args(paper_example()), 200,
                          generator=torch.Generator().manual_seed(1),
                          criterion="rpsdsf", policy="rrr", tie="random")
    assert (x.reshape(200, 4) == torch.tensor([19, 2, 2, 19],
                                              dtype=torch.int32)).all()


def test_max_steps_stops_the_step_loop():
    inst = paper_example()
    x = _torch_fill(inst, torch.Generator().manual_seed(0), criterion="drf",
                    policy="rrr", tie="random", max_steps=7)
    assert x.sum() == 7


def test_mesh_epoch_not_ported():
    """The mesh fill is ported (``tests/test_torch_mesh.py``); on a CPU of
    one logical device two devices are refused, as the reference's
    ``make_agent_mesh`` refuses more devices than the process has."""
    with pytest.raises(ValueError, match="agent mesh wants 2 devices"):
        _torch_fill(paper_example(), criterion="psdsf", policy="pooled",
                    devices=2)
