"""The port's epoch loop as the reference's device-resident loop: the step
function (``engine_torch.EpochLoop``) driven eagerly in chunks of 1, 3 and
64 steps equals ``engine_jax.epoch_loop`` bit for bit on every array it
returns, a step past the end changes nothing, no step syncs the host, and
the graph-cache key holds every static setting.

The instance (seed 3, 8 frameworks x 20 agents, a per-agent limit of 4)
takes 73-77 grants in every criterion/policy pair: more than one chunk of
64, and a count that neither 3 nor 64 divides.  Quantized demands keep
the order-dependent sums exact on both sides."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import engine_jax as ej
from repro_torch.core import engine_torch as et
from repro_torch.core import filling_torch

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("pooled", "rrr")
# the port's path, and the reference's (use_pallas, shards) for it
PATHS = {"plain": (False, 1), "tiles": (True, 1), "shards2": (False, 2)}
N, J, LIMIT, EPS = 8, 20, 4, 1e-9
RETURNS = "ns js count X tot FREE used pidx pos".split()


def _raw():
    rng = np.random.default_rng(3)
    D = 2.0 ** rng.integers(-2, 2, (N, 2))
    C = rng.integers(4, 13, (J, 2)).astype(np.float64)
    allowed = rng.random((N, J)) > 0.25
    allowed[:, 0] = True
    wanted = rng.integers(6, 16, N).astype(np.float64)
    wanted[-1] = 1.0
    phi = np.array([0.5, 1.0, 2.0])[np.arange(N) % 3]
    perms = np.stack([np.random.default_rng(3).permutation(J)
                      for _ in range(8)]).astype(np.int32)
    return (np.zeros((N, J)), D, D, C, C.copy(), phi, wanted, allowed, perms,
            np.zeros(J, np.int32))


@functools.lru_cache(maxsize=None)
def _reference(crit, pol, path, max_steps=128):
    use_pallas, shards = PATHS[path]
    out = ej._jitted(False)(
        *(jnp.asarray(a, jnp.float32) if a.dtype == np.float64
          else jnp.asarray(a) for a in _raw()),
        np.int32(0), np.int32(0), jnp.int32(J), np.int32(LIMIT),
        jnp.float32(EPS), use_pallas=use_pallas, interpret=True,
        shards=shards, kind=crit, policy=pol, lookahead=False,
        use_limit=True, max_steps=max_steps)
    return tuple(np.asarray(a) for a in out)


def _loop(crit, pol, path, max_steps=128):
    """A fresh EpochLoop over the instance's epoch state on the CPU."""
    args = et.epoch_state(*(torch.as_tensor(a) for a in _raw()), 0, 0, J,
                          LIMIT, EPS, kind=crit, lookahead=False,
                          use_limit=True)
    tensors = dict(zip(et.LOOP_TENSORS, args[:16]))
    tensors["perms"] = tensors["perms"].long()
    loop = et.EpochLoop(
        tensors, kind=crit, policy=pol, lookahead=False, use_limit=True,
        max_steps=max_steps, select="tiles" if path == "tiles" else "plain",
        shards=PATHS[path][1])
    loop.reset(0, 0, J, LIMIT, EPS)
    return loop


def _snapshot(loop):
    """Every tensor the loop writes, bit patterns for the floats."""
    ts = [*loop.t.values(), loop.nsjs, loop.count, loop.pidx, loop.pos]
    return [(t.view(torch.int32) if t.dtype == torch.float32 else t).clone()
            for t in ts]


@pytest.mark.parametrize("chunk", [1, 3, 64])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_chunks_equal_reference(crit, pol, path, chunk):
    want = _reference(crit, pol, path)
    count = int(want[2])
    assert count > 64 and count % 3 and count % 64
    got = et.drive(_loop(crit, pol, path), chunk)
    for a, b, name in zip(got, want, RETURNS):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


@pytest.mark.parametrize("max_steps", [128, 40])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_steps_past_the_end_change_nothing(crit, pol, path, max_steps):
    """Past exhaustion (nothing feasible) or past ``max_steps``, a chunk of
    steps leaves every tensor bit for bit as it was."""
    loop = _loop(crit, pol, path, max_steps)
    got = et.drive(loop, 3)
    assert int(got[2]) == min(max_steps, int(_reference(crit, pol,
                                                        path)[2]))
    before = _snapshot(loop)
    loop.run(5)
    assert not bool(loop.flag)
    for a, b in zip(before, _snapshot(loop)):
        assert torch.equal(a, b)


class _NoSync(TorchDispatchMode):
    """Raises on the operations that make a CUDA stream wait for the host:
    reading a device scalar, and the two whose output size depends on the
    data."""

    REFUSED = (torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.masked_select.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise AssertionError(f"{func} syncs the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_chunk_never_syncs(crit, pol, path):
    """What a captured chunk runs — steps that grant, and the alive flag —
    does no operation that syncs the host."""
    loop = _loop(crit, pol, path)
    with _NoSync():
        loop.run(3)
    assert int(loop.count) == 3


@pytest.mark.parametrize("crit,pol,tie", [
    ("drf", "rrr", "random"), ("rpsdsf", "rrr", "low"),
    ("psdsf", "pooled", "random"), ("drf", "bestfit", "random")])
def test_fill_chunk_never_syncs(crit, pol, tie):
    """One chunk of the fill's step loop (what its graph captures) does no
    operation that syncs the host."""
    rng = np.random.default_rng(4)
    D = torch.as_tensor(rng.integers(1, 4, (3, 2)), dtype=torch.float32)
    C = torch.as_tensor(rng.integers(6, 13, (5, 2)), dtype=torch.float32)
    phi = torch.ones(3)
    allowed = torch.as_tensor(rng.random((3, 5)) > 0.2)
    fill = filling_torch.StepFill(D, C, phi, allowed, 4, criterion=crit,
                                  policy=pol, lookahead=False, tie=tie,
                                  chunk=8)
    gens = filling_torch.trial_generators(torch.Generator().manual_seed(2),
                                          4, "cpu")
    fill.start(gens, None, 100)
    fill.draw(gens, 0, 100)
    with _NoSync():
        fill.run()
    assert int(fill.steps) == 8 and int(fill.X.sum()) > 0


def _key_args(**kw):
    tensors = _loop("rpsdsf", "rrr", "plain").t
    loop_kw = dict(kind="rpsdsf", policy="rrr", lookahead=False,
                   use_limit=True, max_steps=128, select="plain", shards=1,
                   dom_big=et.criteria._BIG)
    loop_kw.update(kw)
    return tensors, loop_kw


def test_graph_key_tells_every_static_setting_apart(monkeypatch):
    tensors, base = _key_args()
    key = et.graph_key(tensors, **base)
    changes = [dict(kind="psdsf"), dict(policy="pooled"),
               dict(lookahead=True), dict(use_limit=False),
               dict(max_steps=256), dict(select="tiles"), dict(shards=2),
               dict(dom_big=3.0e38)]
    keys = {et.graph_key(tensors, **{**base, **c}) for c in changes}
    assert key not in keys and len(keys) == len(changes)
    for name, shape in (("X", (16, J)), ("X", (N, 24)), ("D", (N, 3)),
                        ("perms", (9, J))):
        other = dict(tensors)
        other[name] = torch.zeros(shape, dtype=tensors[name].dtype)
        assert et.graph_key(other, **base) != key, name
    monkeypatch.setattr(et, "CHUNK", 32)
    assert et.graph_key(tensors, **base) != key
    monkeypatch.undo()
    tiles = et.graph_key(tensors, **{**base, "select": "tiles"})
    monkeypatch.setattr(et, "_tiles_2d", lambda m, ok, out: (0, 0))
    assert et.graph_key(tensors, **{**base, "select": "tiles"}) != tiles
    assert et.graph_key(tensors, **base) == key


def test_graph_key_is_one_for_a_shape_bucket(monkeypatch):
    """Two fleets of 5 and 7 frameworks on 5 and 7 agents pad to one (8, 8)
    bucket: their segments have one key, so one graph serves both."""
    seen, loop = [], et.run_loop

    def spy(*args, **kw):
        tensors = dict(zip(et.LOOP_TENSORS, args[:16]))
        tensors["perms"] = tensors["perms"].long()
        seen.append(et.graph_key(tensors, **kw))
        return loop(*args, **kw)

    monkeypatch.setattr(et, "run_loop", spy)
    for n in (5, 7):
        rng = np.random.default_rng(n)
        D = 2.0 ** rng.integers(-2, 2, (n, 2))
        C = rng.integers(4, 13, (n, 2)).astype(np.float64)
        grants = et.run_epoch(
            "rpsdsf", "pooled", X=np.zeros((n, n)), D=D, C=C, FREE=C.copy(),
            phi=np.ones(n), allowed=np.ones((n, n), bool),
            wanted=np.full(n, 2.0), true_demands=D, kernel=None,
            device="cpu")
        assert grants
    assert len(seen) == 2 and seen[0] == seen[1]
