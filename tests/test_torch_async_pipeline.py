"""The reference's ``tests/test_async_pipeline.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  Left out: the reference's forced-donation case (the port has
no buffer donation; see the note above its replacement).  The sharded-fill
case holds the port's ``filling_torch`` (shards and the mesh) against the
reference's fill, and the mesh cases run ``devices=K`` epochs on eight
logical CPU devices.

Async epoch pipeline: begin/commit double-buffering, deterministic
simulator commit points, the sharded device-epoch select, the RRR
replay path and the device mesh.

Parity contracts pinned here:

  * allocator level — ``begin_epoch``/``commit_epoch`` grant sequences are
    bit-for-bit equal to the synchronous numpy batched epoch for EVERY
    criterion x policy combo the device engine covers (and the host
    fallback serves the rest through the same begin/commit API);
  * simulator level — ``SimConfig.async_epochs=True`` reproduces the
    synchronous batched traces exactly (makespan, timeline, job durations,
    grant log) on the golden scenario grid for seeds 0-2: the commit point
    (before the next processed event, at the dispatching epoch's simulated
    time) is deterministic by construction;
  * sharded select — ``shards=K`` epochs equal the unsharded loop, and a
    new shard count costs AT MOST one retrace per shape bucket;
  * RRR grow-and-replay and chained segments reproduce the numpy
    sequence (the reference's forced-donation case is left out: the port
    has no buffer donation);
  * the device mesh — ``devices=K`` epochs on the port's mesh equal the
    single-device epoch, and the pooled fill on the mesh equals the
    reference's fill.
"""
import functools

import numpy as np
import pytest

from repro_torch.core import metrics
from repro_torch.core.instance import (
    make_instance,
    spark_cluster_heterogeneous,
)
from repro_torch.core.online import OnlineAllocator as _PortAllocator
from repro_torch.core.simulator import (
    HOMOGENEOUS_AGENTS,
    PI,
    WC,
    SimConfig as _PortSimConfig,
    SparkMesosSim,
    run_paper_experiment,
)


# the port's entry points run on the card unless asked for the CPU
OnlineAllocator = functools.partial(_PortAllocator, device="cpu")
SimConfig = functools.partial(_PortSimConfig, device="cpu")

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
DEVICE_POLICIES = ("pooled", "rrr")


def _instances():
    return {
        "heterogeneous": spark_cluster_heterogeneous(),
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


def _fill(inst, criterion, policy, seed, *, mode="sync", use_kernel=False,
          shards=1, devices=1, cls=None):
    """Drive one epoch over an Instance through the chosen path (on the
    port's allocator, or ``cls``); returns the (fid, agent) grant
    order."""
    al = (cls or OnlineAllocator)(inst.n_resources, criterion=criterion,
                         server_policy=policy, mode="characterized",
                         seed=seed)
    for j in range(inst.n_servers):
        al.add_agent(f"a{j:03d}", inst.capacities[j])
    for n in range(inst.n_frameworks):
        allowed = None
        if not inst.allowed[n].all():
            allowed = [f"a{j:03d}" for j in range(inst.n_servers)
                       if inst.allowed[n, j]]
        al.register(f"f{n:03d}", demand=inst.demands[n], wanted_tasks=10**6,
                    phi=inst.weights[n], allowed_agents=allowed)
    if mode == "async":
        epoch = al.begin_epoch(use_kernel=use_kernel, shards=shards,
                               devices=devices)
        grants = al.commit_epoch(epoch)
    else:
        grants = al.allocate_batched(use_kernel=use_kernel, shards=shards,
                                     devices=devices)
    return [(g.fid, g.agent) for g in grants]


# ---------------------------------------------------------------------------
# allocator-level async parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("pol", DEVICE_POLICIES)
def test_begin_commit_matches_numpy_batched(crit, pol):
    """Async begin/commit == synchronous numpy epoch, bit-for-bit, for every
    covered combo (incl. phi != 1 and placement constraints), and == the
    reference allocator's begin/commit on its device engine."""
    from repro.core.online import OnlineAllocator as RefAllocator

    for name, inst in _instances().items():
        for seed in (0, 1, 2):
            ref = _fill(inst, crit, pol, seed, mode="sync", use_kernel=False)
            got = _fill(inst, crit, pol, seed, mode="async",
                        use_kernel="fused")
            assert ref == got, f"{name}/{seed}"
        assert got == _fill(inst, crit, pol, 2, mode="async",
                            use_kernel="fused", cls=RefAllocator), name


def test_begin_commit_host_fallback_matches_sync():
    """Configurations outside device coverage flow through the SAME
    begin/commit API (host fallback at begin time) with identical grants."""
    inst = spark_cluster_heterogeneous()
    for crit, pol in (("rpsdsf", "bestfit"), ("drf", "bestfit")):
        ref = _fill(inst, crit, pol, 0, mode="sync", use_kernel=False)
        got = _fill(inst, crit, pol, 0, mode="async", use_kernel="fused")
        assert ref == got, f"{crit}/{pol}"


def test_run_epoch_async_is_run_epoch():
    """The engine-level handle API: dispatch-then-result equals the
    blocking wrapper (same inputs, same rng stream position)."""
    from repro_torch.core import engine_torch

    inst = spark_cluster_heterogeneous()
    kw = dict(
        X=np.zeros((2, 6)), D=inst.demands, C=inst.capacities,
        FREE=inst.capacities.copy(), phi=inst.weights, allowed=inst.allowed,
        wanted=np.full(2, 10.0**6), true_demands=inst.demands, device="cpu",
    )
    sync = engine_torch.run_epoch("rpsdsf", "rrr",
                                  rng=np.random.default_rng(3), **kw)
    handle = engine_torch.run_epoch_async("rpsdsf", "rrr",
                                          rng=np.random.default_rng(3), **kw)
    assert handle.in_flight
    seq = handle.result()
    assert not handle.in_flight
    assert seq == sync
    assert handle.result() is seq          # idempotent commit


def test_commit_epoch_guards_against_mutation_and_reuse():
    """The in-flight snapshot is invalidated by ANY state mutation, and an
    epoch cannot be committed twice."""
    al = OnlineAllocator(2, criterion="drf", server_policy="pooled", seed=0)
    for j in range(3):
        al.add_agent(f"a{j}", (8.0, 8.0))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=4)
    epoch = al.begin_epoch(use_kernel="fused")
    al.state.set_wanted("f0", 2)           # mutate mid-flight
    with pytest.raises(RuntimeError, match="mutated"):
        al.commit_epoch(epoch)
    grants = al.allocate_batched(use_kernel="fused")
    assert grants
    done = al.begin_epoch(use_kernel="fused")
    al.commit_epoch(done)
    with pytest.raises(RuntimeError, match="already committed"):
        al.commit_epoch(done)


def test_overlapping_begin_epoch_refused():
    """Only one device epoch may be in flight per allocator: a second
    begin would interleave rng consumption (RRR replay top-ups draw at
    commit) and break the sequence contract."""
    al = OnlineAllocator(2, criterion="drf", server_policy="pooled", seed=0)
    for j in range(3):
        al.add_agent(f"a{j}", (8.0, 8.0))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=4)
    epoch = al.begin_epoch(use_kernel="fused")
    with pytest.raises(RuntimeError, match="in flight"):
        al.begin_epoch(use_kernel="fused")
    al.commit_epoch(epoch)
    al.commit_epoch(al.begin_epoch(use_kernel="fused"))   # usable again


def test_auto_kernel_keeps_rrr_on_host():
    """use_kernel='auto' must never route RRR to the fused path: the fused
    rng pre-draw would make seeded cross-epoch sequences depend on backend
    and cluster size."""
    al = OnlineAllocator(2, criterion="drf", server_policy="rrr", seed=0)
    assert al._resolve_kernel("auto", 2048, 1024, "low") is False
    al2 = OnlineAllocator(2, criterion="drf", server_policy="pooled", seed=0)
    assert al2._resolve_kernel(True, 8, 8, "low") == "fused"


def test_epoch_view_is_frozen():
    """The double-buffered upload view refuses writes."""
    al = OnlineAllocator(2, criterion="drf", seed=0)
    al.add_agent("a0", (4.0, 4.0))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=1)
    view = al.state.epoch_view()
    with pytest.raises(ValueError):
        view.FREE[0, 0] = 0.0
    # the live state is unaffected and still writable
    al.state.grant("f0", "a0", np.array([1.0, 1.0]))


# ---------------------------------------------------------------------------
# simulator-level commit-point determinism (golden scenario grid)
# ---------------------------------------------------------------------------

def _sim_fingerprint(crit, mode, agents, pol, seed, *, async_epochs,
                     use_kernel="auto"):
    cfg = SimConfig(criterion=crit, server_policy=pol, mode=mode,
                    jobs_per_queue=2, seed=seed, batched=True,
                    use_kernel=use_kernel, async_epochs=async_epochs)
    hook = metrics.GrantLogHook()
    sim = SparkMesosSim(agents, {"Pi": PI, "WordCount": WC}, cfg,
                        hooks=[hook])
    r = sim.run()
    return (r.makespan, r.timeline.shape, float(r.timeline.sum()),
            r.tasks_speculated, hook.grants,
            {g: list(map(float, v)) for g, v in r.job_durations.items()})


# the golden_sim_workloads.json scenario grid (criterion/mode/agents/policy),
# re-driven async-vs-sync: the stored golden values pin the sync per-grant
# path; THIS test pins async batched == sync batched on the same scenarios.
GOLDEN_SCENARIOS = (
    ("drf", "characterized", None, "rrr"),
    ("drf", "oblivious", None, "rrr"),
    ("psdsf", "characterized", None, "rrr"),
    ("rpsdsf", "characterized", None, "bestfit"),
    ("tsf", "characterized", HOMOGENEOUS_AGENTS, "pooled"),
)


@pytest.mark.parametrize("crit,mode,agents,pol", GOLDEN_SCENARIOS,
                         ids=lambda v: v if isinstance(v, str) else "")
def test_commit_point_golden_async_equals_sync(crit, mode, agents, pol):
    """Seeds 0-2 of every golden scenario: the async pipeline's commit
    points reproduce the synchronous batched trace bit-for-bit (fused,
    host-fallback and oblivious configurations alike)."""
    from repro_torch.core.simulator import HETEROGENEOUS_AGENTS

    ag = agents or HETEROGENEOUS_AGENTS
    for seed in (0, 1, 2):
        sync = _sim_fingerprint(crit, mode, ag, pol, seed,
                                async_epochs=False, use_kernel="fused")
        asyn = _sim_fingerprint(crit, mode, ag, pol, seed,
                                async_epochs=True, use_kernel="fused")
        assert sync == asyn, f"{crit}/{mode}/{pol}/seed{seed}"


def test_async_requires_batched():
    with pytest.raises(ValueError, match="batched"):
        SparkMesosSim([("a0", (4.0, 4.0))], {"Pi": PI, "WordCount": WC},
                      SimConfig(async_epochs=True, batched=False))


def test_async_auto_kernel_runs_to_completion():
    """async + use_kernel='auto' (the small-cluster host-fallback route)
    completes and matches the sync run."""
    r_sync = run_paper_experiment("psdsf", "characterized", jobs_per_queue=1,
                                  seed=0, batched=True, server_policy="pooled",
                                  device="cpu")
    r_async = run_paper_experiment("psdsf", "characterized", jobs_per_queue=1,
                                   seed=0, batched=True,
                                   server_policy="pooled", async_epochs=True,
                                   device="cpu")
    assert r_sync.makespan == r_async.makespan
    np.testing.assert_array_equal(r_sync.timeline, r_async.timeline)


# ---------------------------------------------------------------------------
# sharded device-epoch select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("pol", DEVICE_POLICIES)
def test_sharded_epoch_matches_unsharded(crit, pol):
    """shards=K partitions the in-loop selects; grant sequences equal the
    unsharded loop AND the numpy engine on every instance."""
    for name, inst in _instances().items():
        ref = _fill(inst, crit, pol, 0, mode="sync", use_kernel=False)
        for shards in (2, 4):
            got = _fill(inst, crit, pol, 0, mode="sync", use_kernel="fused",
                        shards=shards)
            assert ref == got, f"{name}/shards={shards}"


def test_sharded_trace_count_regression():
    """A new shard count retraces AT MOST once per shape bucket; repeats at
    the same (bucket, shards) reuse the cached executable.  The port's
    counterpart of a trace is a captured graph (``CAPTURE_COUNT``), which
    the card takes (``tests/test_torch_cuda.py``); the CPU runs the loop
    eagerly and captures nothing."""
    from repro_torch.core import engine_torch

    inst = spark_cluster_heterogeneous()

    def run(shards, seed=0):
        return _fill(inst, "rpsdsf", "pooled", seed, mode="sync",
                     use_kernel="fused", shards=shards)

    run(2)                                   # enter the (bucket, 2) cache
    t0 = engine_torch.CAPTURE_COUNT
    run(2, seed=1)                           # same bucket + shards: cached
    assert engine_torch.CAPTURE_COUNT == t0
    run(4)                                   # new shard count: <= 1 trace
    assert engine_torch.CAPTURE_COUNT <= t0 + 1
    run(4, seed=1)
    assert engine_torch.CAPTURE_COUNT <= t0 + 1


@pytest.mark.parametrize("pol", DEVICE_POLICIES)
def test_sharded_wanted_exhaustion_and_limit(pol):
    """Mid-epoch ``wanted`` exhaustion + ``per_agent_limit`` under
    shards>1: the sharded loop stops at the reference count and never
    exceeds the per-agent cap."""
    from repro_torch.core import engine_torch

    rng = np.random.default_rng(5)
    N, J, R = 7, 6, 2
    D = rng.uniform(0.5, 1.5, (N, R))
    C = rng.uniform(6.0, 12.0, (J, R))
    kw = dict(X=np.zeros((N, J)), D=D, C=C, FREE=C.copy(),
              phi=rng.uniform(0.5, 2.0, N),
              wanted=rng.integers(1, 3, N).astype(float),  # exhausts early
              allowed=rng.random((N, J)) > 0.2, true_demands=D,
              per_agent_limit=2, device="cpu")
    ref = engine_torch.run_epoch("rpsdsf", pol,
                                 rng=np.random.default_rng(1), **kw)
    got = engine_torch.run_epoch("rpsdsf", pol,
                                 rng=np.random.default_rng(1), shards=2,
                                 **kw)
    assert ref == got
    assert 0 < len(ref) < int(kw["wanted"].sum()) + 1
    counts = np.bincount([j for _n, j in ref])
    assert counts.max() <= 2


def test_auto_partition_floors_clamp_small_epochs():
    """use_kernel='auto' collapses shards/devices requests below the
    measured floors to the plain fused dispatch; explicit specs pass
    through untouched."""
    from repro_torch.core.engine import (
        AUTO_MESH_MIN_CELLS,
        AUTO_SHARD_MIN_CELLS,
    )

    al = OnlineAllocator(2, criterion="drf", server_policy="pooled", seed=0)
    assert al._resolve_partition("auto", 50, 25, 8, 8) == (1, 1)
    big_n = AUTO_SHARD_MIN_CELLS // 1024 + 1
    assert al._resolve_partition("auto", big_n, 1024, 8, 1) == (8, 1)
    big_n = AUTO_MESH_MIN_CELLS // 1024 + 1
    assert al._resolve_partition("auto", big_n, 1024, 1, 8) == (1, 8)
    assert al._resolve_partition("fused", 50, 25, 8, 8) == (8, 8)
    assert al._resolve_partition(True, 50, 25, 4, 2) == (4, 2)


def test_progressive_fill_torch_sharded_parity(monkeypatch):
    """The delegated pooled fill accepts shards and devices (the mesh, on
    two logical CPU devices) and keeps its allocation unchanged: the port's
    ``filling_torch`` in place of the reference's ``filling_jax``, held
    against the reference's fill."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core.filling_jax import progressive_fill_jax
    from repro_torch.core.filling_torch import progressive_fill_torch
    from repro_torch.launch import mesh

    monkeypatch.setattr(mesh, "HOST_DEVICES", 2)
    inst = spark_cluster_heterogeneous()
    args = [torch.as_tensor(a, dtype=torch.float32)
            for a in (inst.demands, inst.capacities, inst.weights)]
    kw = dict(criterion="psdsf", policy="pooled", tie="low")
    base = progressive_fill_torch(*args, **kw)
    sharded = progressive_fill_torch(*args, shards=2, **kw)
    meshed = progressive_fill_torch(*args, devices=2, **kw)
    ref = progressive_fill_jax(
        *(jnp.asarray(a, jnp.float32) for a in (inst.demands,
                                                inst.capacities,
                                                inst.weights)),
        jax.random.key(0), **kw)
    np.testing.assert_array_equal(base.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(base.numpy(), sharded.numpy())
    np.testing.assert_array_equal(base.numpy(), meshed.numpy())


# ---------------------------------------------------------------------------
# RRR grow-and-replay and chained segments
# ---------------------------------------------------------------------------

# Left out: the reference's test_rrr_forced_donation_replay_and_chaining_
# parity.  It forces buffer donation (``_donate=True``), a keyword of the
# reference's jitted engine; the port has no donation (a segment is copied
# into a graph's own buffers and out again, and a dispatch never modifies
# its inputs), so ``engine_torch.run_epoch`` has no such keyword.  The same
# replay and chaining parity without donation is pinned below.

def test_rrr_replay_and_chaining_parity():
    """The RRR grow-and-replay path restarts from the kept segment-start
    tensors; grant sequences still equal the numpy engine, including
    chained overflow segments."""
    from repro_torch.core import engine_torch

    inst = spark_cluster_heterogeneous()
    ref = _fill(inst, "rpsdsf", "rrr", 1, mode="sync", use_kernel=False)

    def fused(**kw):
        return engine_torch.run_epoch(
            "rpsdsf", "rrr", X=np.zeros((2, 6)), D=inst.demands,
            C=inst.capacities, FREE=inst.capacities.copy(),
            phi=inst.weights, allowed=inst.allowed,
            wanted=np.full(2, 10.0**6), true_demands=inst.demands,
            rng=np.random.default_rng(1), device="cpu", **kw)

    order = [(f"f{n:03d}", f"a{j:03d}") for n, j in fused()]
    assert order == ref
    assert [(f"f{n:03d}", f"a{j:03d}")
            for n, j in fused(_perm_rows=2)] == ref        # grow-and-replay
    assert [(f"f{n:03d}", f"a{j:03d}")
            for n, j in fused(max_steps_cap=16, _perm_rows=2)] == ref


# ---------------------------------------------------------------------------
# the device mesh (devices > 1) through the allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("sync", "async"))
@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("pol", DEVICE_POLICIES)
def test_mesh_epoch_matches_unsharded(crit, pol, mode, monkeypatch):
    """``devices=K`` epochs on the port's mesh (eight logical CPU devices)
    equal the single-device fused epoch and the numpy engine on every
    instance, through begin/commit and the synchronous call alike."""
    from repro_torch.core import engine_torch
    from repro_torch.launch import mesh

    monkeypatch.setattr(mesh, "HOST_DEVICES", 8)
    calls, loop = [], engine_torch.epoch_loop_mesh

    def spy(*a, **k):
        calls.append(k["devices"])
        return loop(*a, **k)

    monkeypatch.setattr(engine_torch, "epoch_loop_mesh", spy)
    for name, inst in _instances().items():
        ref = _fill(inst, crit, pol, 0, mode="sync", use_kernel=False)
        for devices in (2, 8):
            got = _fill(inst, crit, pol, 0, mode=mode, use_kernel="fused",
                        devices=devices)
            assert ref == got, f"{name}/devices={devices}"
    assert set(calls) == {2, 8}
