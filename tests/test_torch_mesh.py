"""The port's multi-device allocation epoch (``engine_torch.epoch_loop_mesh``
on a ``repro_torch.launch.mesh.AgentMesh``) against the port's
single-device loop and the reference's ``engine_jax.epoch_loop_mesh``.

On the CPU the mesh takes ``mesh.HOST_DEVICES`` logical devices (the
counterpart of the reference's forced host devices), set by a fixture.
Two layouts run: ``make_agent_mesh`` (one shard a logical device, the
partials crossing devices) and ``shard_devices`` (all shards stacked on one
device).  Equality is bit for bit throughout: the grant sequence and all
nine returned arrays.

The instances are the reference mesh test's (``tests/test_mesh_epoch.py``:
13 frameworks, 11 agents padded to 16 with zero-capacity agents no
framework may use, uniform demands)."""
import os
import subprocess
import sys
import textwrap
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import HAVE_HYPOTHESIS, given, settings, st
from _torch_nosync import NoSync
from test_mesh_epoch import _epoch_args

from repro.core import engine_jax as ej
from repro.core.filling_jax import progressive_fill_jax
from repro.core.instance import make_instance, spark_cluster_heterogeneous
from repro_torch.core import engine_torch as et
from repro_torch.core.filling_torch import progressive_fill_torch
from repro_torch.core.online import OnlineAllocator
from repro_torch.launch import mesh

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("pooled", "rrr")
SHARDS = (1, 2, 4, 8)
LAYOUTS = {"devices": mesh.make_agent_mesh, "one-device": mesh.shard_devices}
RETURNS = "ns js count X tot FREE used pidx pos".split()
J_REAL, J_PAD, MAX_STEPS = 11, 16, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def host_devices(monkeypatch):
    """Eight logical CPU devices for the mesh."""
    monkeypatch.setattr(mesh, "HOST_DEVICES", 8)


def _seed(*key):
    return zlib.crc32(repr(key).encode()) % 2**31


def _pad(a, n, axis, value):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, n - a.shape[axis])
    return np.pad(a, widths, constant_values=value)


def _inputs(crit, pol, limit, wanted_hi=6):
    """The reference test's instance, agents padded to J_PAD, as the raw
    epoch arguments in numpy."""
    kw = _epoch_args(seed=_seed(crit, pol, limit, wanted_hi),
                     wanted_hi=wanted_hi)
    rng = np.random.default_rng(12)
    perms = np.empty((64, J_PAD), np.int32)
    for i in range(64):
        perms[i, :J_REAL] = rng.permutation(J_REAL)
        perms[i, J_REAL:] = np.arange(J_REAL, J_PAD)
    C = _pad(kw["C"], J_PAD, 0, 0.0)
    return (_pad(kw["X"], J_PAD, 1, 0.0), kw["D"], kw["true_demands"], C,
            C.copy(), kw["phi"], kw["wanted"],
            _pad(kw["allowed"], J_PAD, 1, False), perms,
            np.zeros(J_PAD, np.int32))


def _statics(crit, pol, limit):
    return dict(kind=crit, policy=pol, lookahead=False,
                use_limit=limit is not None, max_steps=MAX_STEPS)


def _tail(limit):
    return (0, 0, J_REAL, limit or 0, 1e-9)


def _port_args(raw, limit):
    return tuple(torch.as_tensor(a, dtype=torch.float32)
                 if a.dtype == np.float64 else torch.as_tensor(a)
                 for a in raw) + _tail(limit)


def _reference_mesh(raw, crit, pol, limit):
    """The reference's in-process mesh (one device), jitted."""
    args = tuple(jnp.asarray(a, jnp.float32) if a.dtype == np.float64
                 else jnp.asarray(a) for a in raw)
    out = ej._jitted_mesh()(
        *args, np.int32(0), np.int32(0), jnp.int32(J_REAL),
        np.int32(limit or 0), jnp.float32(1e-9),
        **_statics(crit, pol, limit), devices=1)
    return [np.asarray(a) for a in out]


def _equal(got, want, what):
    for a, b, name in zip(got, want, RETURNS):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("K", SHARDS)
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_mesh_equals_loop_and_reference_mesh(crit, pol, K, layout,
                                             host_devices):
    limit = 3 if crit in ("drf", "rpsdsf") else None
    raw = _inputs(crit, pol, limit)
    kw = _statics(crit, pol, limit)
    got = et.epoch_loop_mesh(*_port_args(raw, limit), **kw,
                             devices=LAYOUTS[layout](K, "cpu"))
    assert int(got[2]) > 0
    _equal(got, et.epoch_loop(*_port_args(raw, limit), **kw, kernel=None),
           "port loop")
    _equal(got, _reference_mesh(raw, crit, pol, limit), "reference mesh")


@pytest.mark.parametrize("K", SHARDS)
@pytest.mark.parametrize("pol", POLICIES)
def test_mesh_wanted_exhaustion_and_limit(pol, K, host_devices):
    """Wanted budgets of 1 or 2 and a per-agent limit of 2 end the epoch
    early: the mesh stops at the reference's count (the select's found
    flag, not a full-matrix guard)."""
    raw = _inputs("rpsdsf", pol, 2, wanted_hi=3)
    kw = _statics("rpsdsf", pol, 2)
    want = _reference_mesh(raw, "rpsdsf", pol, 2)
    count = int(want[2])
    assert 0 < count < MAX_STEPS
    got = et.epoch_loop_mesh(*_port_args(raw, 2), **kw,
                             devices=mesh.make_agent_mesh(K, "cpu"))
    _equal(got, want, "reference mesh")
    assert np.bincount(np.asarray(got[1])[:count]).max() <= 2


def _loop(crit, pol, K, layout, limit=None):
    """A fresh MeshLoop over the instance, started."""
    raw = _inputs(crit, pol, limit)
    args = et.epoch_state(*_port_args(raw, limit), kind=crit,
                          lookahead=False, use_limit=limit is not None)
    m = LAYOUTS[layout](K, "cpu")
    groups = et.mesh_groups(et._loop_tensors(*args[:16]), m, kind=crit,
                            policy=pol)
    loop = et.MeshLoop(groups, m, **_statics(crit, pol, limit))
    loop.reset(*args[16:])
    return loop


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_mesh_step_never_syncs(crit, pol, layout, host_devices):
    """What a captured chunk of the mesh loop runs syncs nothing."""
    loop = _loop(crit, pol, 4, layout)
    with NoSync():
        loop.run(3)
    assert int(loop.st[0]["count"]) == 3


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_mesh_steps_past_the_end_change_nothing(crit, pol, host_devices):
    loop = _loop(crit, pol, 2, "one-device")
    et.drive(loop, 3)
    before = [t.clone() for g in loop.g for t in g.values()] + [
        s[k].clone() for s in loop.st for k in ("count", "nsjs", "pidx",
                                                "pos", "alive")]
    loop.run(4)
    after = [t for g in loop.g for t in g.values()] + [
        s[k] for s in loop.st for k in ("count", "nsjs", "pidx", "pos",
                                        "alive")]
    assert not bool(loop.flag)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def _cache_exact(loop):
    for g in loop.g:
        smin, _ = et._row_scan(g["s"], g["feas"])
        assert torch.equal(g["rmin"], smin)
        masked = torch.where(g["feas"], g["s"], et._BIG)
        at = masked.gather(2, g["rarg"].long()[..., None])[..., 0]
        assert torch.equal(at, g["rmin"])


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="needs hypothesis")
@settings(max_examples=25, deadline=None)
@given(crit=st.sampled_from(["psdsf", "rpsdsf"]), K=st.sampled_from(SHARDS),
       layout=st.sampled_from(sorted(LAYOUTS)),
       limit=st.sampled_from([None, 1, 3]))
def test_row_minima_cache_stays_exact(crit, K, layout, limit):
    """After every step of the pooled PS-DSF/rPS-DSF mesh, each shard's
    cached row minima equal a fresh masked scan of its block and each
    cached column attains its row's minimum: the invariant that lets the
    reference skip the re-scan."""
    old = mesh.HOST_DEVICES
    mesh.HOST_DEVICES = 8
    try:
        loop = _loop(crit, "pooled", K, layout, limit)
        _cache_exact(loop)
        while bool(loop.alive_now()):
            loop.step()
            _cache_exact(loop)
        assert int(loop.st[0]["count"]) > 0
    finally:
        mesh.HOST_DEVICES = old


# -- the mesh's reductions --------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reductions_are_the_elementwise_ones(layout, host_devices):
    m = LAYOUTS[layout](8, "cpu")
    rng = np.random.default_rng(0)
    full = {
        "gmin": torch.as_tensor(rng.standard_normal((8, 5)),
                                dtype=torch.float32),
        "gsum": torch.as_tensor(rng.integers(-9, 9, (8, 5)),
                                dtype=torch.int32),
        "gany": torch.as_tensor(rng.random((8, 5)) > 0.8),
    }
    want = {"gmin": full["gmin"].amin(0),
            "gsum": full["gsum"].sum(0, dtype=torch.int32),
            "gany": full["gany"].any(0)}
    for op, x in full.items():
        got = getattr(m, op)([x[a:b] for _d, a, b in m.groups])
        assert len(got) == len(m.groups)
        for g in got:
            assert torch.equal(g, want[op]), op


def test_one_owner_sum_keeps_bits(host_devices):
    """The RRR owner's column payload: one shard's values, zeros from the
    others, so the sum is the owner's column bit for bit."""
    m = mesh.make_agent_mesh(8, "cpu")
    col = torch.tensor([0.1, 3.0e38, 0.0, 7.25], dtype=torch.float32)
    parts = [torch.zeros((1, 4)) for _ in range(8)]
    parts[5] = col[None]
    for g in m.gsum(parts):
        assert torch.equal(g.view(torch.int32), col.view(torch.int32))


def test_agent_mesh_needs_the_devices(host_devices):
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="wants 2 devices"):
            mesh.make_agent_mesh(2, "cuda")
    with pytest.raises(ValueError, match="wants 9 devices, have 8"):
        mesh.make_agent_mesh(9, "cpu")
    m = mesh.make_agent_mesh(4, "cpu")
    assert m.size == 4 and len(m.groups) == 4 and m.one_device
    s = mesh.shard_devices(4, "cpu")
    assert s.size == 4 and s.groups == [(torch.device("cpu"), 0, 4)]
    assert mesh.as_mesh(s, "cpu") is s
    assert mesh.device_count("cpu") == 8


def test_default_host_devices_is_one():
    assert mesh.HOST_DEVICES == 1 and mesh.device_count("cpu") == 1


# -- the allocator's path: run_epoch_async and OnlineAllocator -------------

def _epoch_kw(seed, N=23, J=17):
    rng = np.random.default_rng(seed)
    D = rng.uniform(0.1, 1.0, (N, 3))
    TD = D * rng.uniform(1.0, 2.0, (N, 1))
    C = rng.uniform(5.0, 10.0, (J, 3))
    return dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
                phi=rng.uniform(0.5, 2.0, N),
                wanted=rng.integers(1, 6, N).astype(float),
                allowed=rng.random((N, J)) > 0.2, true_demands=TD)


def _spy_mesh(monkeypatch):
    calls = []
    loop = et.epoch_loop_mesh

    def spy(*a, **k):
        calls.append(k["devices"])
        return loop(*a, **k)

    monkeypatch.setattr(et, "epoch_loop_mesh", spy)
    return calls


def test_one_host_device_clamps_to_the_single_device_path(monkeypatch):
    """With ``HOST_DEVICES == 1`` a request for 8 devices clamps to one, as
    the reference clamps to its device count."""
    calls = _spy_mesh(monkeypatch)
    kw = _epoch_kw(1)
    one = et.run_epoch("rpsdsf", "pooled", **kw, devices=1, device="cpu")
    eight = et.run_epoch("rpsdsf", "pooled", **kw, devices=8, device="cpu")
    assert one == eight and one and calls == []


@pytest.mark.parametrize("devices,K", [(2, 2), (3, 2), (8, 8), (64, 8)])
def test_requests_floor_to_a_power_of_two(devices, K, host_devices,
                                          monkeypatch):
    calls = _spy_mesh(monkeypatch)
    kw = _epoch_kw(2)
    got = et.run_epoch("drf", "rrr", **kw, rng=np.random.default_rng(4),
                       devices=devices, device="cpu")
    want = et.run_epoch("drf", "rrr", **kw, rng=np.random.default_rng(4),
                        device="cpu")
    assert got == want and calls and set(calls) == {K}


@pytest.mark.parametrize("crit", CRITERIA)
def test_pooled_fill_on_the_mesh(crit, host_devices):
    """``progressive_fill_torch(devices=K)`` == ``devices=1`` == the
    reference's ``progressive_fill_jax(devices=1)``, bit for bit."""
    import jax

    inst = make_instance(
        demands=[[2.0, 2.0], [1.0, 3.5], [1.0, 1.0], [0.5, 2.0]],
        capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0], [9.0, 5.0],
                    [3.0, 7.0], [5.0, 5.0], [12.0, 6.0], [2.0, 9.0]],
        weights=[2.0, 1.0, 0.5, 1.0],
        allowed=np.arange(32).reshape(4, 8) % 5 != 2)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    kw = dict(criterion=crit, policy="pooled", tie="low",
              allowed=torch.as_tensor(inst.allowed))
    base = progressive_fill_torch(t(inst.demands), t(inst.capacities),
                                  t(inst.weights), **kw).numpy()
    ref = np.asarray(progressive_fill_jax(
        jnp.asarray(inst.demands, jnp.float32),
        jnp.asarray(inst.capacities, jnp.float32),
        jnp.asarray(inst.weights, jnp.float32), jax.random.key(0),
        criterion=crit, policy="pooled", tie="low",
        allowed=jnp.asarray(inst.allowed)))
    np.testing.assert_array_equal(base, ref)
    assert base.sum() > 0
    for devices in (2, 4, 8, mesh.shard_devices(4, "cpu")):
        got = progressive_fill_torch(t(inst.demands), t(inst.capacities),
                                     t(inst.weights), devices=devices, **kw)
        np.testing.assert_array_equal(got.numpy(), base)


def test_fill_mesh_needs_a_dividing_server_count(host_devices):
    inst = spark_cluster_heterogeneous()          # 6 agents
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        progressive_fill_torch(t(inst.demands), t(inst.capacities),
                               t(inst.weights), criterion="psdsf",
                               policy="pooled", devices=4)


# -- eight forced JAX host devices: the reference's own 8-device mesh --------

_MESH8 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    from repro.core.engine_jax import run_epoch_async
    from repro.core.online import OnlineAllocator

    assert len(jax.devices()) == 8, jax.devices()
    out = {}

    def inst(seed, N=23, J=17, R=3):
        rng = np.random.default_rng(seed)
        D = rng.uniform(0.1, 1.0, (N, R))
        TD = D * rng.uniform(1.0, 2.0, (N, 1))
        C = rng.uniform(5.0, 10.0, (J, R))
        return dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
                    phi=rng.uniform(0.5, 2.0, N),
                    wanted=rng.integers(1, 6, N).astype(float),
                    allowed=rng.random((N, J)) > 0.2, true_demands=TD)

    for i, kind in enumerate(["drf", "tsf", "psdsf", "rpsdsf"]):
        for k, policy in enumerate(["pooled", "rrr"]):
            limit = 3 if kind in ("drf", "rpsdsf") else None
            kw = inst(100 + 2 * i + k)
            seq = run_epoch_async(kind, policy, rng=np.random.default_rng(7),
                                  per_agent_limit=limit, devices=8,
                                  **kw).result()
            out[f"{kind}/{policy}"] = np.array(seq, np.int64).reshape(-1, 2)

    kw = inst(99)
    for kind in ["drf", "rpsdsf"]:
        seq = run_epoch_async(kind, "rrr", rng=np.random.default_rng(3),
                              max_steps_cap=16, _perm_rows=2, devices=8,
                              **kw).result()
        out[f"chain/{kind}"] = np.array(seq, np.int64).reshape(-1, 2)

    def fill(crit, policy):
        rng = np.random.default_rng(11)
        al = OnlineAllocator(2, criterion=crit, server_policy=policy,
                             mode="characterized", seed=0)
        for j in range(9):
            al.add_agent(f"a{j}", rng.uniform(6.0, 12.0, 2))
        for n in range(7):
            al.register(f"f{n}", demand=rng.uniform(0.5, 2.0, 2),
                        wanted_tasks=6, phi=float(rng.uniform(0.5, 2.0)))
        epoch = al.begin_epoch(use_kernel="fused", devices=8)
        return [(g.fid, g.agent) for g in al.commit_epoch(epoch)]

    for crit, policy in [("rpsdsf", "pooled"), ("drf", "rrr")]:
        out[f"alloc/{crit}/{policy}"] = np.array(fill(crit, policy), str)
    np.savez(sys.argv[1], **out)
    print("MESH8_DONE")
""")


def _port_fill(crit, policy):
    """The same allocator on the port, ``devices=8`` on the CPU."""
    rng = np.random.default_rng(11)
    al = OnlineAllocator(2, criterion=crit, server_policy=policy,
                         mode="characterized", seed=0, device="cpu")
    for j in range(9):
        al.add_agent(f"a{j}", rng.uniform(6.0, 12.0, 2))
    for n in range(7):
        al.register(f"f{n}", demand=rng.uniform(0.5, 2.0, 2),
                    wanted_tasks=6, phi=float(rng.uniform(0.5, 2.0)))
    epoch = al.begin_epoch(use_kernel="fused", devices=8)
    return [(g.fid, g.agent) for g in al.commit_epoch(epoch)]


def test_mesh_equals_reference_on_8_forced_devices(tmp_path, host_devices,
                                                   monkeypatch):
    """The reference's 8-device mesh (forced host devices, in a subprocess:
    the device count locks at JAX's first use) against the port's 8-shard
    mesh: every criterion x policy, chained segments with RRR
    grow-and-replay, and the allocator's begin/commit over ``devices=8``."""
    path = tmp_path / "mesh8.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _MESH8, str(path)],
                          capture_output=True, text=True, timeout=560,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0 and "MESH8_DONE" in proc.stdout, \
        proc.stderr[-3000:]
    ref = np.load(path)
    calls = _spy_mesh(monkeypatch)
    seen = 0
    for i, kind in enumerate(CRITERIA):
        for k, policy in enumerate(POLICIES):
            limit = 3 if kind in ("drf", "rpsdsf") else None
            seq = et.run_epoch(kind, policy, **_epoch_kw(100 + 2 * i + k),
                               rng=np.random.default_rng(7),
                               per_agent_limit=limit, devices=8,
                               device="cpu")
            want = ref[f"{kind}/{policy}"].tolist()
            assert seq == [tuple(p) for p in want] and seq, (kind, policy)
            seen += 1
    for kind in ("drf", "rpsdsf"):
        replays = et.DISPATCH_COUNT
        seq = et.run_epoch(kind, "rrr", **_epoch_kw(99),
                           rng=np.random.default_rng(3), max_steps_cap=16,
                           _perm_rows=2, devices=8, device="cpu")
        assert et.DISPATCH_COUNT - replays > 2      # chained and replayed
        assert seq == [tuple(p) for p in ref[f"chain/{kind}"].tolist()]
    for crit, policy in (("rpsdsf", "pooled"), ("drf", "rrr")):
        got = _port_fill(crit, policy)
        want = [tuple(p) for p in ref[f"alloc/{crit}/{policy}"].tolist()]
        assert got == want and got, (crit, policy)
    assert calls and set(calls) == {8}
