"""The reference's ``tests/test_chaos.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  The quarantine case also runs the allocator's epochs: the
port's mesh while healthy, one device while quarantined.

Chaos suite: fault injection, self-healing dispatch, and the ledger
invariant auditor (repro.core.faults / repro.core.invariants).

The load-bearing guarantees pinned here:

  * an injected fused-dispatch/commit failure recovers through retry or
    the host fallback with a grant sequence BIT-IDENTICAL to the no-fault
    run (all four criteria x pooled/rrr, sync and async begin/commit);
  * abort_epoch() un-wedges a refused or abandoned in-flight epoch (rng
    rewound, subsequent sequences unchanged);
  * K consecutive failures quarantine the device path (auto degrades to
    host, mesh degrades to one device) until a probe epoch succeeds;
  * a corrupted epoch-cache entry is detected on hit, evicted, and
    re-served by a fresh dispatch;
  * random seeded FaultPlans over the golden scenario grid keep the
    invariant auditor green, and with faults disabled the PR-1 golden
    grant sequences reproduce bit-for-bit.
"""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest

import golden_scenario
from repro_torch.core import epoch_cache as _epoch_cache
from repro_torch.core import faults, invariants, metrics
from repro_torch.core.online import OnlineAllocator as _PortAllocator
from repro_torch.core.simulator import (
    HETEROGENEOUS_AGENTS,
    PI,
    WC,
    SimConfig as _PortSimConfig,
    SparkMesosSim,
)


# the port's entry points run on the card unless asked for the CPU
OnlineAllocator = functools.partial(_PortAllocator, device="cpu")
SimConfig = functools.partial(_PortSimConfig, device="cpu")

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")


def _grant_tuples(grants):
    return [(g.fid, g.agent, int(g.n_executors)) for g in grants]


def build_alloc(policy, criterion="drf", seed=0, **kw):
    """A fused-capable cluster: big enough that the device path matters,
    small enough for a fast suite."""
    al = OnlineAllocator(2, criterion=criterion, server_policy=policy,
                        seed=seed, **kw)
    for j in range(6):
        al.add_agent(f"a{j}", (8.0, 16.0))
    for i in range(4):
        al.register(f"f{i}", demand=(1.0 + 0.5 * (i % 2), 2.0),
                    wanted_tasks=6, phi=float(1 + i % 2))
    return al


# ---------------------------------------------------------------------------
# recovery parity: injected device failure == no-fault run, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("policy", ("pooled", "rrr"))
def test_commit_fault_recovers_bit_identical_sync(criterion, policy):
    baseline = _grant_tuples(
        build_alloc(policy, criterion).allocate_batched(use_kernel="fused"))
    inj = faults.EngineFaultInjector(fail_commits=1)
    al = build_alloc(policy, criterion, fault_injector=inj,
                     recovery=faults.RecoveryPolicy(max_retries=0,
                                                    backoff_s=0.0))
    healed = _grant_tuples(al.allocate_batched(use_kernel="fused"))
    assert healed == baseline
    assert al.fault_stats.commit_failures == 1
    assert al.fault_stats.host_fallbacks == 1


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("policy", ("pooled", "rrr"))
def test_dispatch_fault_recovers_bit_identical_async(criterion, policy):
    a = build_alloc(policy, criterion)
    baseline = _grant_tuples(a.commit_epoch(
        a.begin_epoch(use_kernel="fused")))
    # every dispatch attempt (first + retries) fails: begin falls back to
    # the host engine, rng rewound — same sequence.
    inj = faults.EngineFaultInjector(fail_dispatches=10)
    al = build_alloc(policy, criterion, fault_injector=inj,
                     recovery=faults.RecoveryPolicy(max_retries=1,
                                                    backoff_s=0.0))
    epoch = al.begin_epoch(use_kernel="fused")
    assert epoch.grants is not None   # host fallback applied at begin
    healed = _grant_tuples(al.commit_epoch(epoch))
    assert healed == baseline
    assert al.fault_stats.dispatch_failures == 2   # first + one retry
    assert al.fault_stats.host_fallbacks == 1


def test_commit_fault_retry_success_bit_identical():
    baseline = _grant_tuples(
        build_alloc("rrr").allocate_batched(use_kernel="fused"))
    # commit fails once, the re-dispatch succeeds: rescued on-device.
    inj = faults.EngineFaultInjector(fail_commits=1)
    al = build_alloc("rrr", fault_injector=inj,
                     recovery=faults.RecoveryPolicy(max_retries=2,
                                                    backoff_s=0.0))
    healed = _grant_tuples(al.allocate_batched(use_kernel="fused"))
    assert healed == baseline
    assert al.fault_stats.retry_successes == 1
    assert al.fault_stats.host_fallbacks == 0
    assert al.device_health.consecutive_failures == 0


def test_engine_fault_hook_xla_style_failure_recovers():
    """A raise from inside the engine's dispatch boundary (the chaos hook
    models an XLA/device runtime error) heals like an injected fault."""
    from repro_torch.core import engine_torch

    baseline = _grant_tuples(
        build_alloc("pooled").allocate_batched(use_kernel="fused"))
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        if calls["n"] <= 1:
            raise RuntimeError("XLA: device burst into flames")

    engine_torch.fault_hook = boom
    try:
        al = build_alloc("pooled",
                         recovery=faults.RecoveryPolicy(max_retries=1,
                                                        backoff_s=0.0))
        healed = _grant_tuples(al.allocate_batched(use_kernel="fused"))
    finally:
        engine_torch.fault_hook = None
    assert healed == baseline
    assert calls["n"] >= 2
    assert al.fault_stats.retries >= 1


def test_fault_free_injector_is_a_noop():
    """An installed but never-firing injector must not perturb anything."""
    baseline = _grant_tuples(
        build_alloc("rrr").allocate_batched(use_kernel="fused"))
    al = build_alloc("rrr", fault_injector=faults.EngineFaultInjector())
    assert _grant_tuples(al.allocate_batched(use_kernel="fused")) == baseline
    assert al.fault_counters()["injected_dispatch"] == 0


# ---------------------------------------------------------------------------
# abort_epoch: the wedged in-flight epoch regression
# ---------------------------------------------------------------------------

def test_commit_refusal_no_longer_wedges_rng():
    """A mutation-refused commit used to leave the RRR pre-draw consumed:
    the next epoch drew from a shifted stream.  Now the refusal rewinds."""
    # control never begins the doomed epoch: registers "late" up front
    control = build_alloc("rrr")
    control.register("late", demand=(1.0, 1.0), wanted_tasks=2)
    c1 = _grant_tuples(control.allocate_batched(use_kernel="fused"))
    c2 = _grant_tuples(control.allocate_batched(use_kernel="fused"))

    al = build_alloc("rrr")
    epoch = al.begin_epoch(use_kernel="fused")   # draws the RRR prefix
    al.register("late", demand=(1.0, 1.0), wanted_tasks=2)   # mutation!
    with pytest.raises(RuntimeError, match="mutated"):
        al.commit_epoch(epoch)
    assert al.fault_stats.commit_refusals == 1
    assert al._inflight_epoch is None        # not wedged
    # the refused epoch's draws were rewound and its grants never applied:
    # al's state AND rng now equal the control's pre-first-epoch position.
    r1 = _grant_tuples(al.allocate_batched(use_kernel="fused"))
    assert r1 == c1
    r2 = _grant_tuples(al.allocate_batched(use_kernel="fused"))
    assert r2 == c2


def test_abort_epoch_unwedges_and_rewinds():
    control = build_alloc("rrr")
    c1 = _grant_tuples(control.allocate_batched(use_kernel="fused"))

    al = build_alloc("rrr")
    epoch = al.begin_epoch(use_kernel="fused")
    assert al.abort_epoch() is True
    assert al.fault_stats.epoch_aborts == 1
    assert al._inflight_epoch is None
    # begin again: bit-identical to never having begun
    assert _grant_tuples(al.allocate_batched(use_kernel="fused")) == c1
    # double-abort / abort-nothing are no-ops
    assert al.abort_epoch() is False
    assert al.abort_epoch(epoch) is False    # already consumed


def test_abort_epoch_refuses_host_epochs():
    al = build_alloc("pooled")
    epoch = al.begin_epoch(use_kernel=False)   # grants applied at begin
    with pytest.raises(RuntimeError, match="host epoch"):
        al.abort_epoch(epoch)
    al.commit_epoch(epoch)


# ---------------------------------------------------------------------------
# quarantine / probe lifecycle
# ---------------------------------------------------------------------------

def test_quarantine_after_k_failures_and_probe_lift():
    inj = faults.EngineFaultInjector(fail_dispatches=2)
    al = build_alloc("pooled", fault_injector=inj,
                     recovery=faults.RecoveryPolicy(max_retries=0,
                                                    backoff_s=0.0,
                                                    quarantine_after=2,
                                                    probe_every=3))
    events = []
    al.fault_listeners.append(lambda kind, info: events.append(kind))
    al.allocate_batched(use_kernel="fused")     # fail 1 -> host fallback
    assert not al.device_health.quarantined
    al.allocate_batched(use_kernel="fused")     # fail 2 -> quarantined
    assert al.device_health.quarantined
    assert "quarantine" in events
    assert al.fault_stats.host_fallbacks == 2
    # explicit fused epochs still run; the injector is exhausted, so the
    # next success lifts the quarantine (probe semantics)
    al.allocate_batched(use_kernel="fused")
    assert not al.device_health.quarantined
    assert "probe-success" in events


def test_quarantine_gates_auto_resolution(monkeypatch):
    """While quarantined, ``use_kernel="auto"`` resolves to the host path
    except on every probe_every-th attempt."""
    from repro_torch.core import online as online_mod

    monkeypatch.setattr(online_mod, "AUTO_KERNEL_FLOOR_CELLS", 1)
    monkeypatch.setattr(online_mod, "AUTO_KERNEL_MIN_CELLS",
                        {"cpu": 1, "default": 1})
    al = build_alloc("pooled",
                     recovery=faults.RecoveryPolicy(quarantine_after=1,
                                                    probe_every=3))
    N, J = 4, 6
    assert al._resolve_kernel("auto", N, J, "low") == "fused"
    al.device_health.on_failure()
    assert al.device_health.quarantined
    got = [al._resolve_kernel("auto", N, J, "low") for _ in range(6)]
    # denied, denied, probe, denied, denied, probe
    assert got == [False, False, "fused", False, False, "fused"]
    assert al.device_health.probes == 2


def test_quarantine_degrades_mesh_to_single_device(monkeypatch):
    """The partition rule, and the epochs it dispatches: on four logical
    CPU devices a healthy allocator runs the port's mesh, a quarantined
    one the single-device epoch, with the same grants."""
    from repro_torch.core import engine_torch
    from repro_torch.launch import mesh

    monkeypatch.setattr(mesh, "HOST_DEVICES", 4)
    calls, loop = [], engine_torch.epoch_loop_mesh

    def spy(*a, **k):
        calls.append(k["devices"])
        return loop(*a, **k)

    monkeypatch.setattr(engine_torch, "epoch_loop_mesh", spy)
    al = build_alloc("pooled")
    assert al._resolve_partition("fused", 4, 6, 1, 4) == (1, 4)
    healthy = _grant_tuples(build_alloc("pooled").allocate_batched(
        use_kernel="fused", devices=4))
    assert calls == [4] and healthy
    al.device_health.on_failure()
    al.device_health.on_failure()
    al.device_health.on_failure()
    assert al.device_health.quarantined
    assert al._resolve_partition("fused", 4, 6, 1, 4) == (1, 1)
    assert _grant_tuples(al.allocate_batched(use_kernel="fused",
                                             devices=4)) == healthy
    assert calls == [4]
    al.device_health.on_success()
    assert al._resolve_partition("fused", 4, 6, 1, 4) == (1, 4)


# ---------------------------------------------------------------------------
# epoch-cache hit integrity
# ---------------------------------------------------------------------------

def _service_round(al):
    """One serve round: register a fixed profile, allocate, release all —
    the next round freezes the identical profile (a cache hit)."""
    for i in range(3):
        al.register(f"s{i}", demand=(1.0, 2.0), wanted_tasks=4)
    grants = al.allocate_batched(use_kernel=False)
    for i in range(3):
        fid = f"s{i}"
        fw = al.frameworks[fid]
        for agent in list(fw.tasks):
            while fw.tasks.get(agent):
                al.release_executor(fid, agent)
        al.deregister(fid)
    return _grant_tuples(grants)


def test_corrupted_cache_entry_detected_evicted_and_reserved():
    al = OnlineAllocator(2, criterion="drf", server_policy="pooled",
                        seed=0, epoch_cache=True)
    for j in range(4):
        al.add_agent(f"a{j}", (8.0, 16.0))
    first = _service_round(al)
    assert al.epoch_cache.stores == 1
    assert _service_round(al) == first          # clean hit
    assert al.epoch_cache.hits == 1
    key = al.epoch_cache.corrupt_entry(np.random.default_rng(0))
    assert key is not None
    healed = _service_round(al)                 # corrupt hit -> heal
    assert healed == first
    assert al.epoch_cache.corruption_evictions == 1
    assert al.fault_stats.cache_corruptions_evicted == 1
    assert al.epoch_cache.stores == 2           # fresh entry re-stored
    assert _service_round(al) == first          # and it hits clean again
    assert al.epoch_cache.corruption_evictions == 1


def test_seq_digest_roundtrip_and_legacy_entries():
    seq = ((0, 1), (2, 3), (1, 0))
    out = _epoch_cache.EpochOutcome(seq,
                                    seq_digest=_epoch_cache.seq_digest_of(seq))
    assert _epoch_cache.verify_seq(out)
    bad = out._replace(seq=((9, 9),) + seq[1:])
    assert not _epoch_cache.verify_seq(bad)
    # legacy entries (positional construction, no digest) pass vacuously
    legacy = _epoch_cache.EpochOutcome(seq)
    assert legacy.seq_digest == b""
    assert _epoch_cache.verify_seq(legacy)


# ---------------------------------------------------------------------------
# the ledger invariant auditor
# ---------------------------------------------------------------------------

def test_auditor_green_on_honest_ledger():
    al = build_alloc("pooled")
    al.allocate_batched(use_kernel=False)
    assert invariants.check(al) == []
    invariants.assert_invariants(al)


def test_auditor_catches_hand_corrupted_ledger():
    al = build_alloc("pooled")
    al.allocate_batched(use_kernel=False)
    slot = al.state.fid2slot["f0"]
    j = al.state.agent2slot["a0"]
    al.state.X[slot, j] += 1.0                  # phantom executor
    errs = invariants.check(al)
    assert any("X" in e for e in errs)
    with pytest.raises(invariants.InvariantViolation):
        invariants.assert_invariants(al)


def test_auditor_catches_free_capacity_drift():
    al = build_alloc("pooled")
    al.allocate_batched(use_kernel=False)
    al.state.FREE[al.state.agent2slot["a1"], 0] += 3.0
    errs = invariants.check(al)
    assert any("fill" in e or "FREE" in e for e in errs)


def test_auditor_catches_usage_drift():
    al = build_alloc("pooled")
    al.allocate_batched(use_kernel=False)
    al.frameworks["f1"].usage[0] += 1.0
    errs = invariants.check(al)
    assert any("usage" in e for e in errs)


def test_view_agreement_check():
    al = build_alloc("pooled")
    view = al.state.epoch_view()
    invariants.check_view_agreement(al, view)     # memoized: same object
    al.register("intruder", demand=(1.0, 1.0), wanted_tasks=1)
    with pytest.raises(invariants.InvariantViolation):
        invariants.check_view_agreement(al, view)
    invariants.check_view_agreement(al, None)     # None view: vacuous


# ---------------------------------------------------------------------------
# FaultPlan DSL
# ---------------------------------------------------------------------------

def test_fault_plan_flap_and_rack_expansion():
    plan = (faults.FaultPlan()
            .flap("a0", start=10.0, down_for=2.0, up_for=3.0, cycles=2)
            .rack(5.0, ("r0", "r1"), restart_after=4.0)
            .crash(1.0, "x"))
    timed = plan.timed()
    assert [t for t, _ in timed] == sorted(t for t, _ in timed)
    crashes = [ev for _, ev in timed if isinstance(ev, faults.AgentCrash)]
    assert len(crashes) == 5                     # 2 flap + 2 rack + 1 plain
    flap = [ev for ev in crashes if ev.agent == "a0"]
    assert [ev.time for ev in flap] == [10.0, 15.0]
    assert all(ev.restart_after == 2.0 for ev in flap)
    rack = [ev for ev in crashes if ev.agent.startswith("r")]
    assert {ev.time for ev in rack} == {5.0}
    assert all(ev.restart_after == 4.0 for ev in rack)


def test_fault_plan_from_failures_and_empty():
    plan = faults.FaultPlan.from_failures([(7.0, "a1"), (9.0, "a2")])
    assert len(plan.timed()) == 2
    assert all(ev.restart_after is None for _, ev in plan.timed())
    assert not plan.empty
    assert faults.FaultPlan().empty
    assert faults.FaultPlan().make_injector() is None
    assert faults.FaultPlan(p_dispatch=0.1).make_injector() is not None


def test_fault_plan_random_is_seed_deterministic():
    agents = [a for a, _ in HETEROGENEOUS_AGENTS]
    p1 = faults.FaultPlan.random(agents, ("Pi-q0-j0",), seed=3)
    p2 = faults.FaultPlan.random(agents, ("Pi-q0-j0",), seed=3)
    assert p1.timed() == p2.timed()
    assert p1.timed()          # never empty: at least one crash


# ---------------------------------------------------------------------------
# simulator chaos: random plans keep the auditor green; no faults = golden
# ---------------------------------------------------------------------------

def _sim(criterion, policy, seed, plan=None, **cfg_kw):
    cfg = SimConfig(criterion=criterion, server_policy=policy,
                    jobs_per_queue=2, n_queues_per_group=1,
                    batched=True, use_kernel=False, audit=True,
                    faults=plan, seed=seed, **cfg_kw)
    hook = metrics.FaultLogHook()
    sim = SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                        cfg, hooks=[hook])
    return sim.run(until=2000.0), hook


@pytest.mark.parametrize("criterion,policy,seed", [
    ("drf", "rrr", 0), ("tsf", "pooled", 1), ("psdsf", "bestfit", 2),
    ("rpsdsf", "rrr", 3), ("drf", "pooled", 4),
])
def test_chaos_property_suite_auditor_stays_green(criterion, policy, seed):
    """Random seeded fault plans over the golden scenario grid: every
    post-commit (and post-event) ledger state passes the auditor — the
    auditor raises InvariantViolation inside run() otherwise."""
    agents = [a for a, _ in HETEROGENEOUS_AGENTS]
    plan = faults.FaultPlan.random(
        agents, (f"Pi-q0-j{seed % 2}",), seed=seed, intensity=0.8)
    res, hook = _sim(criterion, policy, seed, plan=plan)
    assert res.makespan > 0
    assert res.fault_stats is not None
    assert res.fault_stats["agent_crashes"] >= 1
    # every crash with a restart that fired is visible to the hooks
    assert hook.counts.get("agent-crash", 0) >= 1


def test_crash_restart_cycle_restores_capacity():
    plan = faults.FaultPlan().crash(6.0, "type2-0", restart_after=5.0)
    res, hook = _sim("drf", "rrr", 0, plan=plan)
    assert res.fault_stats["agent_crashes"] == 1
    assert res.fault_stats["agent_restarts"] == 1
    assert hook.counts["agent-crash"] == 1
    assert hook.counts["agent-restart"] == 1


def test_framework_disconnect_rejoin():
    plan = faults.FaultPlan().disconnect(8.0, "Pi-q0-j0", rejoin_after=4.0)
    res, hook = _sim("drf", "rrr", 0, plan=plan)
    assert res.fault_stats["fw_disconnects"] == 1
    assert res.fault_stats["fw_rejoins"] == 1
    assert hook.counts["fw-disconnect"] == 1
    assert hook.counts["fw-rejoin"] == 1


def test_empty_fault_plan_reproduces_faultless_run_exactly():
    g0 = metrics.GrantLogHook()
    cfg = SimConfig(criterion="drf", server_policy="rrr", jobs_per_queue=2,
                    n_queues_per_group=1, batched=True, use_kernel=False,
                    seed=0)
    SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                  cfg, hooks=[g0]).run(until=2000.0)
    g1 = metrics.GrantLogHook()
    cfg1 = SimConfig(criterion="drf", server_policy="rrr", jobs_per_queue=2,
                     n_queues_per_group=1, batched=True, use_kernel=False,
                     audit=True, faults=faults.FaultPlan(), seed=0)
    SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                  cfg1, hooks=[g1]).run(until=2000.0)
    assert g1.grants == g0.grants


@pytest.mark.parametrize("key", [
    "drf/rrr/0", "tsf/pooled/1", "rpsdsf/bestfit/2", "psdsf/rrr/3",
])
def test_faults_disabled_reproduces_pr1_golden_sequences(monkeypatch, key):
    """With the chaos layer installed but disabled (audit on, zero-rate
    injector), the PR-1 golden grant sequences reproduce bit-for-bit."""
    with open(golden_scenario.GOLDEN_PATH) as f:
        golden = json.load(f)

    def chaos_alloc(*args, **kw):
        kw.setdefault("audit", True)
        kw.setdefault("fault_injector", faults.EngineFaultInjector())
        return OnlineAllocator(*args, **kw)

    monkeypatch.setattr(golden_scenario, "OnlineAllocator", chaos_alloc)
    crit, pol, seed = key.split("/")
    got = golden_scenario.run_scenario(crit, pol, int(seed))
    assert [list(g) for g in got] == golden[key]
