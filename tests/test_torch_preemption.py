"""The reference's ``tests/test_preemption.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  The golden case drives the reference's scenario script with
the port's allocator; the host-vs-device parity case also holds the
reference allocator's fused epoch.

Revocable offers & the epoch-level preemption pass.

Contracts pinned here (see ``src/repro/core/preemption.py``):

  * grant-time classification — grants under the phi-weighted fair share
    (``criteria.fair_share_level``) are firm, grants past
    ``threshold * level`` are revocable (ClusterState ``Xr`` ledger);
  * the preemption pass — starved under-share frameworks trigger
    revocations of the most-over-share victims (shared criterion scores,
    max first), minimal revocation, then regrant in the same epoch;
  * engine parity — revoke sequences are identical on EVERY path (the pass
    is shared and rng-free) and revoke+grant sequences match across the
    numpy-batched and fused-device epochs for all four criteria (RRR
    compared per-epoch, matching the documented cross-epoch rng caveat),
    and across per-grant vs batched for the deterministic combos;
  * async — revocation during an in-flight epoch is REFUSED (not
    deferred), and async simulator traces with preemption enabled equal
    the sync traces bit-for-bit;
  * preemption-off (and never-triggering thresholds) reproduce the
    existing golden grant sequences bit-for-bit.
"""
import functools
import json

import numpy as np
import pytest

from repro_torch.core import metrics
from repro_torch.core.online import OnlineAllocator as _PortAllocator
from repro_torch.core.preemption import PreemptionPolicy, Revocation
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


# The classification/pass-mechanics tests below pin the PRE-hysteresis pass
# semantics (victims revocable the epoch after the grant), so they disable
# the freshness filter explicitly; hysteresis itself is regression-tested in
# test_hysteresis_* below and in tests/test_tenancy.py.
def _alloc(criterion="drf", policy="pooled", seed=0,
           preemption=PreemptionPolicy(hysteresis_epochs=0),
           agents=((4.0, 4.0), (4.0, 4.0))):
    al = OnlineAllocator(2, criterion=criterion, server_policy=policy,
                         seed=seed, preemption=preemption)
    for j, cap in enumerate(agents):
        al.add_agent(f"a{j}", cap)
    return al


# ---------------------------------------------------------------------------
# grant-time firm/revocable classification
# ---------------------------------------------------------------------------

def test_lone_framework_grants_are_firm():
    """A framework alone is entitled to everything: nothing is revocable."""
    al = _alloc()
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=100)
    gs = al.allocate(batched=True)
    assert gs and not any(g.revocable for g in gs)
    assert al.state.Xr.sum() == 0


def test_grants_past_fair_share_become_revocable():
    """f1 grabbing beyond its half while f0 wants little: the over-share
    grants are revocable and ride in the Xr ledger."""
    al = _alloc()
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    gs = al.allocate(batched=True)
    rev = [g for g in gs if g.revocable]
    assert rev and all(g.fid == "f1" for g in rev)
    # ledger agrees across layers: Grant flags == ClusterState.Xr == fw dict
    assert al.state.Xr.sum() == len(rev)
    assert sum(al.frameworks["f1"].revocable.values()) == len(rev)
    # f1's dominant share before its last FIRM grant was <= 1/2
    firm = [g for g in gs if g.fid == "f1" and not g.revocable]
    assert len(firm) * 1.0 / 8.0 <= 0.5 + 1e-9


def test_threshold_loosens_classification():
    """threshold=2 tolerates up to 2x the fair share before revocability."""
    al = _alloc(preemption=PreemptionPolicy(threshold=2.0))
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)
    # f1 ends at 6/8 = 0.75 dominant share < 2 * 0.5: all firm
    assert al.state.Xr.sum() == 0


def test_phi_weighted_fair_share():
    """phi=2 doubles the entitlement: revocability starts past 2/3 here."""
    al = _alloc(agents=((6.0, 6.0),))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=100, phi=2.0)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=0, phi=1.0)
    gs = al.allocate(batched=True)
    # level = 1/3; f0 weighted share after k grants = (k/6)/2 > 1/3 <=> k > 4
    flags = [g.revocable for g in gs]
    assert flags == [False, False, False, False, True, True]


def test_release_drains_revocable_ledger_first():
    al = _alloc()
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)
    before = al.state.Xr.sum()
    assert before > 0
    agent = next(a for a, k in al.frameworks["f1"].revocable.items() if k > 0)
    al.release_executor("f1", agent)
    assert al.state.Xr.sum() == before - 1
    # releases and revokes keep the invariant 0 <= Xr <= X
    assert (al.state.Xr >= 0).all() and (al.state.Xr <= al.state.X).all()


def test_oblivious_mode_rejected():
    with pytest.raises(ValueError, match="characterized"):
        OnlineAllocator(2, mode="oblivious", preemption=PreemptionPolicy())


def test_cluster_state_revoke_validates_ledger():
    al = _alloc()
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=2)
    al.allocate(batched=True)
    with pytest.raises(ValueError, match="no revocable"):
        al.revoke_executor("f0", "a0")
    with pytest.raises(ValueError, match="revocable"):
        al.state.revoke("f0", "a0", np.array([1.0, 1.0]))


# ---------------------------------------------------------------------------
# the preemption pass: starvation -> revoke -> regrant
# ---------------------------------------------------------------------------

def _starvation_setup(criterion="drf", policy="pooled", seed=0, **pol_kw):
    """f1 grabs beyond its share while f0 wants little; then f0's demand
    grows back against a full cluster -> f0 is starved.  One agent, so the
    victim's revocable executors concentrate where they can help."""
    pol_kw.setdefault("hysteresis_epochs", 0)
    al = _alloc(criterion=criterion, policy=policy, seed=seed,
                agents=((8.0, 8.0),),
                preemption=PreemptionPolicy(**pol_kw))
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)
    al.set_wanted("f0", 3)
    return al


@pytest.mark.parametrize("crit", CRITERIA)
def test_starved_framework_triggers_revoke_then_regrant(crit):
    al = _starvation_setup(criterion=crit)
    gs = al.allocate(batched=True)
    revs = al.last_revocations
    assert revs and all(isinstance(r, Revocation) for r in revs)
    assert all(r.fid == "f1" for r in revs)
    # the freed space is regranted to the starved framework IN THIS epoch
    assert any(g.fid == "f0" for g in gs)
    # minimal revocation: every revocation was on the agent that ended up
    # hosting f0 (just enough space freed, nowhere else touched)
    assert {r.agent for r in revs} == {g.agent for g in gs if g.fid == "f0"}
    # capacity accounting survived revoke+regrant
    for free in al.free.values():
        assert (free >= -1e-9).all()
    assert (al.state.Xr >= 0).all() and (al.state.Xr <= al.state.X).all()


def test_under_share_victims_are_never_revoked():
    """Sticky classification, current-share victimhood: a framework that
    dropped back UNDER its fair share keeps its revocable ledger but is
    not a victim."""
    al = _starvation_setup()
    # f1 voluntarily sheds down to under-share before the starved epoch
    fw = al.frameworks["f1"]
    while fw.usage[0] / 8.0 > 0.4:
        agent = next(a for a, t in fw.tasks.items() if t)
        al.release_executor("f1", agent)
    al._preempt_pass()
    assert al.last_revocations == []


def test_unsatisfiable_demand_triggers_no_revocation():
    """A starved framework whose demand fits NO agent's total capacity can
    never be helped: the pass must not thrash the victims."""
    al = _alloc(agents=((8.0, 8.0),))
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)
    assert al.state.Xr.sum() > 0            # victims exist...
    al.register("giant", demand=(100.0, 100.0), wanted_tasks=1)
    al._preempt_pass()
    assert al.last_revocations == []        # ...but can never help the giant


def test_constraints_restrict_revocations_to_helpful_agents():
    """Revocations only land on agents allowed for a starved framework —
    even when the victim holds revocable executors elsewhere."""
    al = _alloc(agents=((4.0, 4.0), (4.0, 4.0)))
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)
    assert any(k > 0 for k in al.frameworks["f1"].revocable.values())
    al.register("f2", demand=(1.0, 1.0), wanted_tasks=2,
                allowed_agents=["a1"])
    al.allocate(batched=True)
    assert al.last_revocations and all(
        r.agent == "a1" for r in al.last_revocations)


def test_victim_order_is_most_over_share_first():
    al = _alloc(agents=((12.0, 12.0),), policy="pooled")
    al.register("small", demand=(2.0, 2.0), wanted_tasks=1)
    al.register("mid", demand=(1.0, 1.0), wanted_tasks=4)
    al.register("big", demand=(1.0, 1.0), wanted_tasks=100)
    al.allocate(batched=True)   # big ends far over share, mid at/just over
    al.set_wanted("small", 3)
    al.allocate(batched=True)
    assert al.last_revocations
    # the first victim is the most-over-share framework
    assert al.last_revocations[0].fid == "big"


def test_max_revocations_budget():
    al = _starvation_setup(max_revocations_per_epoch=1)
    al.allocate(batched=True)
    assert len(al.last_revocations) == 1


# ---------------------------------------------------------------------------
# engine parity: revoke+regrant sequences across paths
# ---------------------------------------------------------------------------

def _drive_epochs(criterion, policy, final_path, seed=3, reference=False):
    """Setup epochs always run the host-batched path (identical state and
    rng position on every variant); only the FINAL epoch — which revokes
    and regrants — runs on the path under test.  RRR parity is therefore
    per-epoch, matching the engine_torch cross-epoch rng caveat.  With
    ``reference``, the reference's allocator runs the same script."""
    cls, policy_cls = OnlineAllocator, PreemptionPolicy
    if reference:
        from repro.core.online import OnlineAllocator as cls
        from repro.core.preemption import PreemptionPolicy as policy_cls
    al = cls(2, criterion=criterion, server_policy=policy, seed=seed,
             preemption=policy_cls(hysteresis_epochs=0))
    for j, cap in enumerate([(4.0, 14.0), (8.0, 8.0), (6.0, 11.0)]):
        al.add_agent(f"a{j}", cap)
    al.register("f0", demand=(2.0, 2.0), wanted_tasks=1, phi=2.0)
    al.register("f1", demand=(1.0, 3.5), wanted_tasks=100)
    al.register("f2", demand=(1.0, 1.0), wanted_tasks=100, phi=0.5)
    al.allocate_batched(use_kernel=False)
    al.set_wanted("f0", 5)
    if final_path == "pergrant":
        gs = al.allocate()
    elif final_path == "batched":
        gs = al.allocate_batched(use_kernel=False)
    elif final_path == "fused":
        gs = al.allocate_batched(use_kernel=True)
    else:  # async begin/commit over the fused engine
        gs = al.commit_epoch(al.begin_epoch(use_kernel=True))
    return ([(g.fid, g.agent, g.revocable) for g in gs],
            [(r.fid, r.agent) for r in al.last_revocations])


@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("pol", ("pooled", "rrr"))
def test_revoke_regrant_parity_host_vs_device(crit, pol):
    """numpy-batched == fused-device == async begin/commit: identical
    revocation AND grant sequences (flags included) for every covered
    criterion x policy combo, and == the reference allocator's fused
    epoch on the same script."""
    host = _drive_epochs(crit, pol, "batched")
    dev = _drive_epochs(crit, pol, "fused")
    asy = _drive_epochs(crit, pol, "async")
    assert host[1], f"{crit}/{pol}: scenario produced no revocations"
    assert host == dev == asy
    assert dev == _drive_epochs(crit, pol, "fused", reference=True)


@pytest.mark.parametrize("crit,pol", (
    ("psdsf", "pooled"), ("rpsdsf", "pooled"),
    ("drf", "bestfit"), ("tsf", "bestfit"),
))
def test_revoke_regrant_parity_pergrant_vs_batched(crit, pol):
    """Per-grant == batched on the deterministic combos (the same coverage
    assert_batched_parity pins; rng-driven combos differ by construction)."""
    assert _drive_epochs(crit, pol, "pergrant") == \
        _drive_epochs(crit, pol, "batched")


@pytest.mark.parametrize("crit", CRITERIA)
def test_revocation_sequence_is_engine_independent(crit):
    """The pass consumes no rng: the revocation sequence alone matches on
    EVERY path, including the rng-driven per-grant ones."""
    seqs = {p: _drive_epochs(crit, "rrr", p)[1]
            for p in ("pergrant", "batched", "fused", "async")}
    assert len(set(map(tuple, seqs.values()))) == 1, seqs


# ---------------------------------------------------------------------------
# async protocol: in-flight revocation is refused, not deferred
# ---------------------------------------------------------------------------

def test_revocation_refused_while_epoch_in_flight():
    al = _starvation_setup(criterion="drf", policy="pooled")
    agent = next(a for a, k in al.frameworks["f1"].revocable.items() if k > 0)
    epoch = al.begin_epoch(use_kernel=True)   # fused: stays in flight
    assert epoch.in_flight
    with pytest.raises(RuntimeError, match="refused"):
        al.revoke_executor("f1", agent)
    al.commit_epoch(epoch)
    # after the commit point the same revocation is legal
    if al.frameworks["f1"].revocable.get(agent, 0) > 0:
        assert al.revoke_executor("f1", agent).fid == "f1"


# ---------------------------------------------------------------------------
# preemption off (and never-triggering) == existing goldens
# ---------------------------------------------------------------------------

def test_preemption_off_reproduces_golden_grants(monkeypatch):
    """Explicit pin of the acceptance bar: the default (preemption=None)
    allocator reproduces the pre-preemption golden grant sequences (the
    reference's scenario script, driven with the port's allocator)."""
    import golden_scenario

    monkeypatch.setattr(golden_scenario, "OnlineAllocator", OnlineAllocator)
    with open(golden_scenario.GOLDEN_PATH) as f:
        golden = json.load(f)
    for key in ("drf/rrr/0", "rpsdsf/bestfit/1", "tsf/pooled/2"):
        crit, pol, seed = key.split("/")
        got = golden_scenario.run_scenario(crit, pol, int(seed))
        assert [tuple(e) for e in golden[key]] == [tuple(e) for e in got], key


def test_never_triggering_threshold_is_bitwise_noop():
    """preemption ENABLED with an unreachable threshold classifies nothing
    revocable and revokes nothing — grant sequences are bit-for-bit the
    preemption-off ones (the machinery itself adds no divergence)."""
    def run(preemption):
        al = _alloc(criterion="rpsdsf", policy="rrr", seed=1,
                    preemption=preemption,
                    agents=((4.0, 14.0), (8.0, 8.0), (6.0, 11.0)))
        al.register("pi", demand=PI.demand, wanted_tasks=20)
        al.register("wc", demand=WC.demand, wanted_tasks=20)
        out = [[(g.fid, g.agent) for g in al.allocate(per_agent_limit=1)]]
        out.append([(g.fid, g.agent) for g in al.allocate(batched=True)])
        assert al.state.Xr.sum() == 0
        return out

    assert run(None) == run(PreemptionPolicy(threshold=1e18))


# ---------------------------------------------------------------------------
# revocation hysteresis (ROADMAP follow-on; default hysteresis_epochs=2)
# ---------------------------------------------------------------------------

def test_hysteresis_protects_fresh_grants():
    """The default policy never revokes a grant made within the last 2
    epochs: the starved epoch right after the land-grab revokes nothing."""
    al = _starvation_setup(criterion="drf", hysteresis_epochs=2)
    al.allocate(batched=True)
    assert al.last_revocations == []


def test_hysteresis_expires_after_k_epochs():
    """Once the victim's grants age past k epochs the same starvation
    triggers the usual revocations."""
    al = _starvation_setup(criterion="drf", hysteresis_epochs=2)
    al.allocate(batched=True)           # epoch 2: grants fresh -> protected
    assert al.last_revocations == []
    al.allocate(batched=True)           # epoch 3: age 2 >= k -> revocable
    assert al.last_revocations
    assert all(r.fid == "f1" for r in al.last_revocations)


def test_hysteresis_zero_is_bitwise_noop():
    """hysteresis_epochs=0 reproduces the pre-hysteresis pass exactly."""
    def run(**kw):
        al = _starvation_setup(criterion="rpsdsf", policy="pooled", **kw)
        gs = al.allocate(batched=True)
        return ([(g.fid, g.agent, g.revocable) for g in gs],
                [(r.fid, r.agent) for r in al.last_revocations])

    assert run(hysteresis_epochs=0) == run(hysteresis_epochs=0)
    assert run(hysteresis_epochs=0)[1]     # the scenario does revoke


def test_hysteresis_stops_fragment_thrash_oscillation():
    """The PR-5 fragment-thrash scenario, epoch-looped: without hysteresis
    a revoke -> regrant -> revoke cycle can oscillate the same executors
    across consecutive epochs; with the default policy no (framework,
    agent) pair is ever revoked within 2 epochs of its latest grant, so
    back-to-back revocations of freshly regranted executors cannot occur
    (and the allocation still converges to the starved framework's fill)."""
    def drive(k):
        al = _alloc(agents=((8.0, 8.0),),
                    preemption=PreemptionPolicy(hysteresis_epochs=k))
        al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
        al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
        al.allocate(batched=True)
        # oscillation driver: f0 bursts (starving against the full
        # cluster), finishes and releases, f1 re-grabs the space as fresh
        # revocable grants, f0 bursts again ...
        events = []
        for epoch in range(6):
            if epoch % 2 == 0:
                al.set_wanted("f0", 3)
            else:
                fw = al.frameworks["f0"]
                while fw.n_tasks > 1:
                    agent = next(a for a, t in fw.tasks.items() if t)
                    al.release_executor("f0", agent)
                al.set_wanted("f0", 1)
            al.allocate(batched=True)
            events.append([(r.fid, r.agent) for r in al.last_revocations])
        return events

    churn0 = drive(0)
    churn2 = drive(2)
    # un-hysteresis'd: revocations recur across the alternating epochs
    assert sum(1 for e in churn0 if e) >= 2
    # hysteresis: once a pair is (re)granted, 2 epochs must pass before it
    # can be revoked again -> no back-to-back revocation epochs
    for a, b in zip(churn2, churn2[1:]):
        assert not (a and b), (churn2, "back-to-back revocation epochs")
    assert sum(1 for e in churn2 if e) <= sum(1 for e in churn0 if e)


# ---------------------------------------------------------------------------
# simulator: restart-after-revoke + async trace parity
# ---------------------------------------------------------------------------

def _sim_fingerprint(crit, pol, seed, *, preemption, async_epochs):
    cfg = SimConfig(criterion=crit, server_policy=pol, jobs_per_queue=2,
                    seed=seed, batched=True, async_epochs=async_epochs,
                    preemption=preemption)
    g, p = metrics.GrantLogHook(), metrics.PreemptionHook()
    sim = SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                        cfg, hooks=[g, p])
    r = sim.run()
    return {
        "makespan": r.makespan,
        "timeline": float(r.timeline.sum()),
        "grants": g.grants,
        "revoked": g.revoked,
        "durations": {k: list(map(float, v))
                      for k, v in r.job_durations.items()},
        "counters": (r.executors_revoked, r.tasks_requeued_on_revoke,
                     round(r.revoked_wasted_s, 9), p.summary()),
    }


@pytest.mark.parametrize("crit,pol", (("drf", "rrr"), ("rpsdsf", "bestfit")))
def test_async_sim_traces_equal_sync_with_preemption(crit, pol):
    for seed in (0, 1):
        sync = _sim_fingerprint(crit, pol, seed, preemption=True,
                                async_epochs=False)
        asyn = _sim_fingerprint(crit, pol, seed, preemption=True,
                                async_epochs=True)
        assert sync == asyn, f"{crit}/{pol}/seed{seed}"
        assert sync["counters"][0] > 0   # the scenario actually preempts


def test_simulator_restarts_revoked_work_and_completes():
    fp = _sim_fingerprint("drf", "rrr", 0, preemption=True,
                          async_epochs=False)
    n_exec, n_requeued, wasted, hook = fp["counters"]
    assert n_exec > 0 and fp["revoked"]
    assert sum(n for _f, _a, n in fp["revoked"]) == n_exec
    assert hook["executors_revoked"] == n_exec
    assert hook["revoked_wasted_s"] == pytest.approx(wasted)
    # every job still completes despite revocations (restart semantics)
    assert sum(len(v) for v in fp["durations"].values()) == 20
    assert wasted >= 0.0 and n_requeued >= 0


def test_sim_preemption_off_trace_unchanged_by_feature():
    """SimConfig(preemption=False) — the default — produces the same trace
    as before the subsystem existed (pinned against the enabled-but-inert
    configuration too)."""
    off = _sim_fingerprint("psdsf", "rrr", 0, preemption=False,
                           async_epochs=False)
    assert off["counters"][0] == 0 and off["revoked"] == []
