"""The port's OnlineAllocator (device="cpu") against the reference's: the
golden per-grant sequences, begin/commit == sync, self-healing recovery to
the reference's fused grants, and checkpoint carry-over from a reference
allocator into the port, and a kernel error that is raised, not
healed."""
import functools
import json

import pytest
import torch

import golden_scenario
from repro.core.instance import make_instance, spark_cluster_heterogeneous
from repro.core.online import OnlineAllocator as RefAllocator
from repro_torch.core import engine_torch, faults
from repro_torch.core.online import OnlineAllocator

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("rrr", "pooled", "bestfit")
DEVICE_POLICIES = ("pooled", "rrr")
PortAllocator = functools.partial(OnlineAllocator, device="cpu")


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_golden_online_grant_sequences(crit, pol, monkeypatch):
    """tests/golden_online_grants.json, seeds 0-4, driven through the
    reference's own scenario script with the port's allocator."""
    with open(golden_scenario.GOLDEN_PATH) as f:
        gold = json.load(f)
    monkeypatch.setattr(golden_scenario, "OnlineAllocator", PortAllocator)
    for seed in golden_scenario.SEEDS:
        got = [list(g) for g in golden_scenario.run_scenario(crit, pol, seed)]
        assert got == gold[f"{crit}/{pol}/{seed}"], seed


def _instances():
    return {
        "heterogeneous": spark_cluster_heterogeneous(),
        "weighted": make_instance(
            demands=[[2.0, 2.0], [1.0, 3.5], [1.0, 1.0]],
            capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0]],
            weights=[2.0, 1.0, 0.5]),
        "constrained": make_instance(
            demands=[[2.0, 2.0], [1.0, 3.5]],
            capacities=[[4.0, 14.0], [8.0, 8.0], [6.0, 11.0]],
            weights=[1.0, 2.0],
            allowed=[[True, True, False], [True, True, True]]),
    }


def _fill(cls, inst, crit, pol, seed, *, mode, use_kernel):
    al = cls(inst.n_resources, criterion=crit, server_policy=pol, seed=seed)
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
        grants = al.commit_epoch(al.begin_epoch(use_kernel=use_kernel))
    else:
        grants = al.allocate_batched(use_kernel=use_kernel)
    return [(g.fid, g.agent) for g in grants]


@pytest.mark.parametrize("pol", DEVICE_POLICIES)
@pytest.mark.parametrize("crit", CRITERIA)
def test_begin_commit_equals_sync_and_reference(crit, pol):
    for name, inst in _instances().items():
        for seed in (0, 1, 2):
            sync = _fill(PortAllocator, inst, crit, pol, seed, mode="sync",
                         use_kernel=False)
            got = _fill(PortAllocator, inst, crit, pol, seed, mode="async",
                        use_kernel="fused")
            assert got == sync, f"{name}/{seed}"
    ref = _fill(RefAllocator, spark_cluster_heterogeneous(), crit, pol, 0,
                mode="async", use_kernel="fused")
    assert ref == _fill(PortAllocator, spark_cluster_heterogeneous(), crit,
                        pol, 0, mode="async", use_kernel="fused")


def _build(cls, policy, criterion, **kw):
    """The reference chaos suite's fused-capable cluster."""
    al = cls(2, criterion=criterion, server_policy=policy, seed=0, **kw)
    for j in range(6):
        al.add_agent(f"a{j}", (8.0, 16.0))
    for i in range(4):
        al.register(f"f{i}", demand=(1.0 + 0.5 * (i % 2), 2.0),
                    wanted_tasks=6, phi=float(1 + i % 2))
    return al


def _tuples(grants):
    return [(g.fid, g.agent, int(g.n_executors)) for g in grants]


@pytest.mark.parametrize("policy", DEVICE_POLICIES)
@pytest.mark.parametrize("criterion", CRITERIA)
def test_fault_recovery_equals_reference_fused(criterion, policy):
    """A failed commit (sync) and failed dispatches (async) heal through
    the host engine with the rng rewound: the grants are the reference's
    fault-free fused grants, as tests/test_chaos.py checks them."""
    baseline = _tuples(_build(RefAllocator, policy, criterion)
                       .allocate_batched(use_kernel="fused"))
    al = _build(PortAllocator, policy, criterion,
                fault_injector=faults.EngineFaultInjector(fail_commits=1),
                recovery=faults.RecoveryPolicy(max_retries=0, backoff_s=0.0))
    assert _tuples(al.allocate_batched(use_kernel="fused")) == baseline
    assert al.fault_stats.commit_failures == 1
    assert al.fault_stats.host_fallbacks == 1
    al = _build(PortAllocator, policy, criterion,
                fault_injector=faults.EngineFaultInjector(fail_dispatches=10),
                recovery=faults.RecoveryPolicy(max_retries=1, backoff_s=0.0))
    epoch = al.begin_epoch(use_kernel="fused")
    assert epoch.grants is not None
    assert _tuples(al.commit_epoch(epoch)) == baseline
    assert al.fault_stats.dispatch_failures == 2
    assert al.fault_stats.host_fallbacks == 1


def test_engine_fault_hook_failure_recovers():
    """A raise at the engine's dispatch boundary heals like an injected
    fault: retried on the device path, same grants."""
    baseline = _tuples(_build(PortAllocator, "pooled", "drf")
                       .allocate_batched(use_kernel="fused"))
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] <= 1:
            raise RuntimeError("device error")

    engine_torch.fault_hook = boom
    try:
        al = _build(PortAllocator, "pooled", "drf",
                    recovery=faults.RecoveryPolicy(max_retries=1,
                                                   backoff_s=0.0))
        healed = _tuples(al.allocate_batched(use_kernel="fused"))
    finally:
        engine_torch.fault_hook = None
    assert healed == baseline and calls["n"] >= 2
    assert al.fault_stats.retries >= 1 and al.fault_stats.host_fallbacks == 0


@pytest.mark.parametrize("where", ["dispatch", "commit"])
def test_kernel_error_is_raised_not_healed(where, monkeypatch):
    """A kernel that does not build, launch or run is not a transient
    fault: the allocator raises instead of finishing the epoch on the
    host, where a broken kernel would pass for a working one.  A device
    fault seen at the readback reaches the caller as a KernelError."""
    from repro_torch.kernels import KernelError

    def boom(*_a, **_k):
        if where == "dispatch":
            raise KernelError("nvcc failed on epoch.cu")
        raise torch.AcceleratorError("CUDA error: an illegal memory access")

    if where == "dispatch":
        monkeypatch.setattr(engine_torch, "fault_hook", boom)
    else:
        monkeypatch.setattr(engine_torch._EpochRun, "_finish", boom)
    al = _build(PortAllocator, "rrr", "rpsdsf",
                recovery=faults.RecoveryPolicy(max_retries=2, backoff_s=0.0))
    rng0 = al.rng.bit_generator.state
    with pytest.raises(KernelError):
        al.allocate_batched(use_kernel="fused")
    fs = al.fault_stats
    assert fs.retries == fs.host_fallbacks == 0
    assert not any(al.state.X.ravel())
    if where == "dispatch":
        assert al.rng.bit_generator.state == rng0


def _epochs(al, k):
    out = []
    for _ in range(k):
        grants = al.allocate_batched(per_agent_limit=2, use_kernel="fused")
        out.append(_tuples(grants))
        for g in grants[::2]:
            al.release_executor(g.fid, g.agent)
    return out


@pytest.mark.parametrize("crit,pol", [("rpsdsf", "rrr"), ("drf", "pooled"),
                                      ("tsf", "rrr")])
def test_checkpoint_carries_over_from_reference(crit, pol):
    """A reference checkpoint restores into the port unchanged; both then
    grant identically and leave identical rng streams."""
    ref = RefAllocator(2, criterion=crit, server_policy=pol, seed=4)
    for name, cap in golden_scenario.HETEROGENEOUS_AGENTS:
        ref.add_agent(name, cap)
    ref.register("pi", demand=(2.0, 2.0), wanted_tasks=9)
    ref.register("wc", demand=(1.0, 3.5), wanted_tasks=9, phi=2.0)
    ref.register("hi", demand=(1.0, 1.0), wanted_tasks=4, phi=0.5,
                 allowed_agents=["type2-0", "type3-1"])
    _epochs(ref, 3)
    port = PortAllocator(2, criterion=crit, server_policy=pol, seed=99)
    port.restore(ref.checkpoint())
    assert _epochs(port, 3) == _epochs(ref, 3)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state
    assert (port.checkpoint()["state"].keys()
            == ref.checkpoint()["state"].keys())
