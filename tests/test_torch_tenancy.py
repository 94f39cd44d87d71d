"""The reference's ``tests/test_tenancy.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  The golden case drives the reference's scenario script with
the port's allocator.

Multi-tenant control plane: admission queues, quota floors, credits.

Contracts pinned here (see ``src/repro/core/tenancy.py`` and
``docs/tenancy.md``):

  * admission — arrivals queue in the control plane and the gate at the
    top of every epoch drains them in dominant-share-over-queued-demand
    order (jumped entries first, ties by arrival sequence), consuming NO
    rng (property: deterministic across replays);
  * quota floors — a tenant at or under its floor is NEVER a preemption
    victim (property), and a lone tenant's ABOVE-floor grants are
    revocable (the lone-tenant fix: firmness up to the floor no longer
    depends on who else is registered);
  * credits — per-tenant conservation ``accrued - spent == balance``
    (property), queue jumps admit first, shields block revocation for the
    window and expire after it;
  * bit-for-bit — tenancy OFF reproduces the PR-1 golden grant sequences,
    and tenancy ON with zero floors + an untouched ledger reproduces the
    plain preemption-on traces across criteria x policies, sync + async;
  * durability — checkpoint/restore and journal replay round-trip the
    control plane (``recovery_parity`` green); the PR-8 invariant auditor
    stays green after every admission / grant / revoke.
"""
import functools
import json

import numpy as np
import pytest

from repro_torch.core import invariants, metrics
from repro_torch.core.online import OnlineAllocator as _PortAllocator
from repro_torch.core.preemption import PreemptionPolicy
from repro_torch.core.simulator import (
    HETEROGENEOUS_AGENTS,
    PI,
    WC,
    SimConfig as _PortSimConfig,
    SparkMesosSim,
)
from repro_torch.core.tenancy import (
    ControlPlane,
    TenancyConfig,
    get_control_plane,
)
from tests._hypo import HAVE_HYPOTHESIS, given, settings, st


# the port's entry points run on the card unless asked for the CPU
OnlineAllocator = functools.partial(_PortAllocator, device="cpu")
SimConfig = functools.partial(_PortSimConfig, device="cpu")

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")


def _alloc(criterion="drf", policy="pooled", seed=0, tenancy=True,
           preemption=PreemptionPolicy(hysteresis_epochs=0),
           agents=((4.0, 4.0), (4.0, 4.0))):
    al = OnlineAllocator(2, criterion=criterion, server_policy=policy,
                         seed=seed, preemption=preemption, tenancy=tenancy)
    for j, cap in enumerate(agents):
        al.add_agent(f"a{j}", cap)
    return al


# ---------------------------------------------------------------------------
# config + control-plane bookkeeping
# ---------------------------------------------------------------------------

def test_floor_of_listed_and_default():
    cfg = TenancyConfig(floors=(("acme", 0.4),), default_floor=0.1)
    assert cfg.floor_of("acme") == 0.4
    assert cfg.floor_of("other") == 0.1
    assert TenancyConfig().floor_of("anyone") == 0.0


def test_get_control_plane_specs():
    assert get_control_plane(None) is None
    assert get_control_plane(False) is None
    assert isinstance(get_control_plane(True), ControlPlane)
    cfg = TenancyConfig(default_floor=0.2)
    assert get_control_plane(cfg).cfg is cfg
    cp = ControlPlane(cfg)
    assert get_control_plane(cp) is cp
    with pytest.raises(ValueError, match="tenancy spec"):
        get_control_plane("nope")


def test_enqueue_assigns_monotonic_seqs():
    cp = ControlPlane(TenancyConfig())
    e0 = cp.enqueue("f0", "t0", (1.0, 1.0), 1, 1.0, None, 0.0)
    e1 = cp.enqueue("f1", "t1", (1.0, 1.0), 1, 1.0, None, 0.0)
    assert (e0.seq, e1.seq) == (0, 1)
    # replayed seqs (journal recovery) keep the counter past the max
    cp.enqueue("f2", "t2", None, 1, 1.0, None, 0.0, seq=10)
    assert cp.enqueue("f3", "t3", None, 1, 1.0, None, 0.0).seq == 11


def test_spend_insufficient_balance_raises():
    cp = ControlPlane(TenancyConfig())
    cp.accrue("t0", 3.0)
    with pytest.raises(ValueError, match="credits"):
        cp.spend("t0", 5.0)
    cp.spend("t0", 3.0)
    assert cp.balance("t0") == 0.0


def test_credit_maps_conserve_unit():
    cp = ControlPlane(TenancyConfig())
    for t, amt in (("a", 5.0), ("b", 2.0), ("a", 1.0)):
        cp.accrue(t, amt)
    cp.spend("a", 4.0)
    for t in ("a", "b"):
        assert cp.accrued.get(t, 0.0) - cp.spent.get(t, 0.0) == cp.balance(t)


def test_admission_order_jumped_first_then_score_then_seq():
    cp = ControlPlane(TenancyConfig())
    cp.enqueue("hungry", "low-share", (2.0, 2.0), 4, 1.0, None, 0.0)
    cp.enqueue("rich", "high-share", (2.0, 2.0), 4, 1.0, None, 0.0)
    cp.enqueue("late", "low-share", (2.0, 2.0), 4, 1.0, None, 1.0)
    shares = {"low-share": 0.1, "high-share": 0.9}
    order = [e.fid for e in cp.admission_order(shares, np.array([8.0, 8.0]))]
    assert order == ["hungry", "late", "rich"]   # score asc, tie by seq
    cp.find_queued("rich").jumped = True
    order = [e.fid for e in cp.admission_order(shares, np.array([8.0, 8.0]))]
    assert order == ["rich", "hungry", "late"]   # jumped precedes everything


def test_admission_order_new_tenants_by_arrival():
    cp = ControlPlane(TenancyConfig())
    for i in range(4):
        cp.enqueue(f"f{i}", f"t{i}", (1.0, 1.0), 1, 1.0, None, 0.0)
    order = [e.fid for e in cp.admission_order({}, np.array([8.0, 8.0]))]
    assert order == ["f0", "f1", "f2", "f3"]


if HAVE_HYPOTHESIS:
    _entries = st.lists(
        st.tuples(st.sampled_from(("t0", "t1", "t2")),
                  st.floats(0.25, 4.0), st.integers(1, 6),
                  st.booleans()),
        min_size=1, max_size=12)
else:  # pragma: no cover - collection-time placeholder
    _entries = None


@given(entries=_entries,
       shares=st.fixed_dictionaries(
           {"t0": st.floats(0, 1), "t1": st.floats(0, 1),
            "t2": st.floats(0, 1)}))
@settings(max_examples=60, deadline=None)
def test_property_admission_order_is_deterministic_total(entries, shares):
    """The ordering is a pure function of (queue, shares, capacity): two
    control planes fed the same arrivals produce the same total order, and
    every queued entry appears exactly once."""
    def build():
        cp = ControlPlane(TenancyConfig())
        for i, (t, d, w, jump) in enumerate(entries):
            e = cp.enqueue(f"f{i}", t, (d, d), w, 1.0, None, 0.0)
            e.jumped = jump
        return cp
    a, b = build(), build()
    ctot = np.array([16.0, 16.0])
    oa = [e.fid for e in a.admission_order(shares, ctot)]
    ob = [e.fid for e in b.admission_order(shares, ctot)]
    assert oa == ob
    assert sorted(oa) == sorted(e.fid for e in a.queue)


# ---------------------------------------------------------------------------
# the admission gate (allocator integration)
# ---------------------------------------------------------------------------

def test_submit_admission_registers_at_next_epoch():
    al = _alloc()
    al.submit_admission("f0", demand=(1.0, 1.0), wanted_tasks=2, now=3.0)
    assert "f0" not in al.frameworks and al.tenancy.has_queued("f0")
    gs = al.allocate()
    assert "f0" in al.frameworks and not al.tenancy.queue
    assert sum(g.n_executors for g in gs) == 2
    assert al.last_admissions == [("f0", "f0", 3.0)]


def test_submit_admission_requires_control_plane():
    al = _alloc(tenancy=None)
    with pytest.raises(RuntimeError, match="tenancy"):
        al.submit_admission("f0", demand=(1.0, 1.0))


def test_submit_admission_refuses_duplicates():
    al = _alloc()
    al.register("reg", demand=(1.0, 1.0), wanted_tasks=1)
    with pytest.raises(ValueError, match="registered"):
        al.submit_admission("reg", demand=(1.0, 1.0))
    al.submit_admission("f0", demand=(1.0, 1.0))
    with pytest.raises(ValueError, match="queued"):
        al.submit_admission("f0", demand=(1.0, 1.0))


def test_admission_budget_bounds_the_gate():
    al = _alloc(tenancy=TenancyConfig(max_admissions_per_epoch=1))
    for i in range(3):
        al.submit_admission(f"f{i}", demand=(1.0, 1.0), wanted_tasks=1)
    al.allocate()
    assert len(al.frameworks) == 1 and len(al.tenancy.queue) == 2
    al.allocate()
    assert len(al.frameworks) == 2 and len(al.tenancy.queue) == 1


def test_tenant_defaults_to_fid_and_is_sticky():
    al = _alloc()
    al.submit_admission("solo", demand=(1.0, 1.0))
    al.submit_admission("lane", demand=(1.0, 1.0), tenant="acme")
    al.allocate()
    assert al.tenancy.tenant_of["solo"] == "solo"
    assert al.tenancy.tenant_of["lane"] == "acme"


def test_gate_prefers_low_share_tenants():
    """A tenant already holding capacity queues behind a fresh one even
    when it arrived first (dominant-share-over-queued-demand order)."""
    al = _alloc(agents=((8.0, 8.0),))
    al.submit_admission("a-0", demand=(1.0, 1.0), wanted_tasks=4, tenant="a")
    al.allocate()                                    # tenant a holds 4/8
    al.last_admissions.clear()
    al.submit_admission("a-1", demand=(1.0, 1.0), wanted_tasks=2, tenant="a")
    al.submit_admission("b-0", demand=(1.0, 1.0), wanted_tasks=2, tenant="b")
    al.allocate()
    adm = [fid for fid, _t, _tq in al.last_admissions]
    assert adm == ["b-0", "a-1"]


def test_gate_consumes_no_rng():
    """Identical arrival histories admit identically on the rng-driven
    pooled policy — the gate draws nothing from the allocator stream."""
    def run():
        al = _alloc(policy="pooled", seed=7)
        for i in range(5):
            al.submit_admission(f"f{i}", demand=(1.0, 1.0), wanted_tasks=2,
                                tenant=f"t{i % 2}")
        out = []
        for _ in range(3):
            al.allocate()
            out.append([fid for fid, _t, _q in al.last_admissions])
            al.last_admissions.clear()
        return out
    assert run() == run()


# ---------------------------------------------------------------------------
# quota floors
# ---------------------------------------------------------------------------

def test_lone_tenant_above_floor_grants_revocable():
    """The lone-tenant fix: with a floor, firmness is absolute — grants
    past the floor are revocable even with nobody else registered (under
    the membership-relative rule a lone framework is never over share)."""
    al = _alloc(tenancy=TenancyConfig(floors=(("solo", 0.25),)))
    al.submit_admission("f0", demand=(1.0, 1.0), wanted_tasks=8,
                        tenant="solo")
    gs = al.allocate()
    flags = [g.revocable for g in gs]
    # 8 agents' worth? two (4,4) agents = 8 units: floor 0.25 -> 2 firm
    assert flags == [False, False, True, True, True, True, True, True]
    # contrast: no floor -> the membership-relative rule, all firm
    al2 = _alloc()
    al2.submit_admission("f0", demand=(1.0, 1.0), wanted_tasks=8,
                         tenant="solo")
    assert not any(g.revocable for g in al2.allocate())


def test_newcomer_reclaims_excess_from_lone_floor_tenant():
    """End-to-end lone-tenant scenario: the incumbent grabs everything,
    a newcomer arrives, the pass revokes the incumbent down toward its
    floor and the newcomer places — no deregistration needed."""
    al = _alloc(tenancy=TenancyConfig(floors=(("inc", 0.25),)))
    al.submit_admission("inc-0", demand=(1.0, 1.0), wanted_tasks=8,
                        tenant="inc")
    al.allocate()
    assert al.frameworks["inc-0"].n_tasks == 8
    al.submit_admission("new-0", demand=(2.0, 2.0), wanted_tasks=2,
                        tenant="new")
    gs = al.allocate()
    assert [r.fid for r in al.last_revocations] == ["inc-0", "inc-0"]
    assert any(g.fid == "new-0" for g in gs)


def test_floor_tenant_never_victim_at_or_below_floor():
    """A floor tenant holding exactly its floor is not in the victim pool
    even while other frameworks starve."""
    al = _alloc(tenancy=TenancyConfig(floors=(("prot", 0.25),)))
    al.submit_admission("p0", demand=(1.0, 1.0), wanted_tasks=2,
                        tenant="prot")       # exactly the 0.25 floor
    al.allocate()
    # a greedy unfloored tenant takes the rest firm+revocable, then a
    # newcomer starves: revocations must come from the greedy tenant only
    al.submit_admission("g0", demand=(1.0, 1.0), wanted_tasks=6,
                        tenant="greedy")
    al.allocate()
    al.submit_admission("n0", demand=(2.0, 2.0), wanted_tasks=1,
                        tenant="new")
    al.allocate()
    assert al.last_revocations, "scenario never triggered the pass"
    assert all(r.fid == "g0" for r in al.last_revocations)
    assert al.frameworks["p0"].n_tasks == 2


def test_revocations_stop_at_the_floor():
    """Per-round floor recheck: over enough epochs the pass (minimal — one
    placeable task per starved framework per epoch) walks the over-floor
    tenant down TO its floor, never through it."""
    al = _alloc(tenancy=TenancyConfig(floors=(("inc", 0.5),)))
    al.submit_admission("inc-0", demand=(1.0, 1.0), wanted_tasks=8,
                        tenant="inc")
    al.allocate()
    al.submit_admission("new-0", demand=(1.0, 1.0), wanted_tasks=8,
                        tenant="new")
    for _ in range(8):
        al.allocate()
    assert al._tenant_shares()["inc"] >= 0.5 - 1e-9
    assert al.frameworks["inc-0"].n_tasks == 4
    assert al.frameworks["new-0"].n_tasks == 4


def test_floor_uses_tenant_aggregate_share():
    """Two frameworks of one tenant share the floor budget: classification
    sums the TENANT's holdings, not the framework's."""
    al = _alloc(tenancy=TenancyConfig(floors=(("t", 0.5),)),
                agents=((8.0, 8.0),))
    al.submit_admission("t-0", demand=(1.0, 1.0), wanted_tasks=3, tenant="t")
    al.allocate()
    al.submit_admission("t-1", demand=(1.0, 1.0), wanted_tasks=3, tenant="t")
    gs = [g for g in al.allocate() if g.fid == "t-1"]
    # aggregate crosses 4/8 = floor on t-1's second grant
    assert [g.revocable for g in gs] == [False, True, True]


if HAVE_HYPOTHESIS:
    _floor_grid = st.tuples(
        st.floats(0.125, 0.5), st.integers(1, 8), st.integers(1, 8),
        st.sampled_from(CRITERIA))
else:  # pragma: no cover
    _floor_grid = None


@given(args=_floor_grid)
@settings(max_examples=40, deadline=None)
def test_property_no_below_floor_tenant_is_ever_a_victim(args):
    """For any floor / demand mix / criterion: every revocation leaves the
    victim tenant's aggregate share at or above its floor (the floor is a
    hard lower bound on what preemption can take)."""
    floor, w_inc, w_new, crit = args
    al = _alloc(criterion=crit,
                tenancy=TenancyConfig(floors=(("inc", floor),)))
    al.submit_admission("inc-0", demand=(1.0, 1.0), wanted_tasks=w_inc,
                        tenant="inc")
    al.allocate()
    al.submit_admission("new-0", demand=(2.0, 2.0), wanted_tasks=w_new,
                        tenant="new")
    al.allocate()
    # the floor is a hard lower bound up to one revocation quantum (each
    # (1,1) bundle is 1/8 of dominant capacity): a revocation is only ever
    # INITIATED while the tenant sits strictly above its floor
    granted = min(w_inc, 8)
    assert al._tenant_shares().get("inc", 0.0) >= \
        min(floor, granted / 8.0) - 0.125 - 1e-9
    assert invariants.check(al) == []


# ---------------------------------------------------------------------------
# credits
# ---------------------------------------------------------------------------

def test_accrual_goes_to_under_split_tenants_only():
    al = _alloc(agents=((8.0, 8.0),))
    al.submit_admission("rich-0", demand=(1.0, 1.0), wanted_tasks=7,
                        tenant="rich")
    al.submit_admission("poor-0", demand=(1.0, 1.0), wanted_tasks=1,
                        tenant="poor")
    al.allocate()        # epoch 1: accrual runs pre-grant (both at 0: both
    for _ in range(3):   # accrue once), then rich grabs 7/8
        al.allocate()    # epochs 2-4: only poor (1/8 < the 1/2 split)
    cp = al.tenancy
    assert cp.balance("rich") == 1.0
    assert cp.balance("poor") == 4.0
    assert cp.accrued == {"rich": 1.0, "poor": 4.0} and cp.spent == {}


def test_queue_jump_spends_and_admits_first():
    al = _alloc(tenancy=TenancyConfig(max_admissions_per_epoch=1,
                                      queue_jump_cost=2.0),
                agents=((8.0, 8.0),))
    al.submit_admission("a", demand=(1.0, 1.0), tenant="first")
    al.submit_admission("b", demand=(1.0, 1.0), tenant="late")
    # give "late" a balance, then jump its queued entry ahead of "a"
    cp = al.tenancy
    cp.accrue("late", 2.0)
    al.spend_queue_jump("b")
    assert cp.find_queued("b").jumped
    al.allocate()
    assert [fid for fid, _t, _q in al.last_admissions] == ["b"]
    # the spend emptied the balance; the admission epoch then accrued 1.0
    # (the lone registered tenant sits under its split with zero usage)
    assert cp.spent["late"] == 2.0
    assert cp.balance("late") == cp.accrued["late"] - 2.0
    assert cp.jumps_total == 1


def test_queue_jump_without_balance_raises():
    al = _alloc()
    al.submit_admission("f0", demand=(1.0, 1.0), tenant="broke")
    with pytest.raises(ValueError, match="credits"):
        al.spend_queue_jump("f0")
    assert not al.tenancy.find_queued("f0").jumped


def test_shield_blocks_revocation_then_expires():
    """A purchased shield excludes the tenant from the victim pool for
    exactly ``shield_epochs`` allocation epochs (the over-floor holdings
    that would otherwise be revoked survive the window, then fall)."""
    cfg = TenancyConfig(floors=(("g", 0.25),), shield_cost=1.0,
                        shield_epochs=2)
    al = _alloc(tenancy=cfg)
    al.submit_admission("g0", demand=(1.0, 1.0), wanted_tasks=8, tenant="g")
    al.allocate()
    al.tenancy.accrue("g", 1.0)
    al.spend_shield("g")
    al.submit_admission("n0", demand=(1.0, 1.0), wanted_tasks=1, tenant="n")
    al.allocate()
    assert not al.last_revocations            # shielded: pass skips g
    al.allocate()
    assert not al.last_revocations            # window covers this epoch too
    al.allocate()                             # expired: revocation lands
    assert [r.fid for r in al.last_revocations] == ["g0"]
    assert al.frameworks["n0"].n_tasks == 1
    assert al.tenancy.shields_total == 1


if HAVE_HYPOTHESIS:
    _ops = st.lists(st.tuples(st.sampled_from(("accrue", "jump", "epoch")),
                              st.integers(0, 2)),
                    min_size=1, max_size=20)
else:  # pragma: no cover
    _ops = None


@given(ops=_ops)
@settings(max_examples=40, deadline=None)
def test_property_credits_conserve_under_any_op_sequence(ops):
    """accrued - spent == balance for every tenant after ANY interleaving
    of accruals, queue jumps and allocation epochs (spends that exceed the
    balance raise and change nothing)."""
    al = _alloc(tenancy=TenancyConfig(queue_jump_cost=2.0))
    tenants = ("t0", "t1", "t2")
    qn = 0
    for op, k in ops:
        t = tenants[k]
        if op == "accrue":
            al.tenancy.accrue(t, 1.5)
        elif op == "jump":
            fid = f"q{qn}"
            qn += 1
            al.submit_admission(fid, demand=(1.0, 1.0), tenant=t)
            try:
                al.spend_queue_jump(fid)
            except ValueError:
                pass
        else:
            al.allocate()
        cp = al.tenancy
        for tt in set(cp.credits) | set(cp.accrued) | set(cp.spent):
            assert abs(cp.accrued.get(tt, 0.0) - cp.spent.get(tt, 0.0)
                       - cp.balance(tt)) < 1e-9
        assert invariants.check(al) == []


# ---------------------------------------------------------------------------
# bit-for-bit: tenancy off == goldens; floors=0 + empty ledger == plain
# ---------------------------------------------------------------------------

def test_tenancy_off_reproduces_golden_grants(monkeypatch):
    """The acceptance bar: an explicitly tenancy-less allocator reproduces
    the PR-1 golden grant sequences bit-for-bit (the reference's scenario
    script, driven with the port's allocator)."""
    import golden_scenario

    monkeypatch.setattr(golden_scenario, "OnlineAllocator", OnlineAllocator)
    with open(golden_scenario.GOLDEN_PATH) as f:
        golden = json.load(f)
    for key in ("drf/rrr/0", "psdsf/pooled/3", "rpsdsf/bestfit/1"):
        crit, pol, seed = key.split("/")
        got = golden_scenario.run_scenario(crit, pol, int(seed))
        assert [tuple(e) for e in golden[key]] == [tuple(e) for e in got], key


def _preemption_trace(crit, pol, *, tenancy, seed=0):
    """Fixed churn scenario through the preemption pass; returns the full
    (grants+flags, revocations) trace.  Frameworks register DIRECTLY (the
    admission queue is a front door, not a requirement), so an attached
    but untouched control plane must be invisible."""
    al = _alloc(criterion=crit, policy=pol, seed=seed, tenancy=tenancy,
                preemption=PreemptionPolicy(),
                agents=((4.0, 14.0), (8.0, 8.0), (6.0, 11.0)))
    al.register("pi", demand=tuple(PI.demand), wanted_tasks=6)
    al.register("wc", demand=tuple(WC.demand), wanted_tasks=6)
    trace = []
    for round_ in range(6):
        gs = al.allocate(batched=True)
        trace.append(([(g.fid, g.agent, g.revocable) for g in gs],
                      [(r.fid, r.agent) for r in al.last_revocations]))
        if round_ == 2:
            al.set_wanted("pi", 1)
            for a in list(al.frameworks["pi"].tasks):
                while al.frameworks["pi"].tasks.get(a):
                    al.release_executor("pi", a)
        if round_ == 3:
            al.set_wanted("pi", 8)
    return trace


@pytest.mark.parametrize("crit", CRITERIA)
@pytest.mark.parametrize("pol", ("pooled", "rrr"))
def test_zero_floors_empty_ledger_is_bitwise_plain_preemption(crit, pol):
    """Tenancy attached with all-zero floors and no credit spends is
    bit-for-bit the plain preemption-on allocator — every grant, flag and
    revocation — for all four criteria on both rng-driven policies."""
    assert _preemption_trace(crit, pol, tenancy=None) == \
        _preemption_trace(crit, pol, tenancy=TenancyConfig())


def _sim_fingerprint(crit, pol, *, tenancy, async_epochs, seed=0):
    cfg = SimConfig(criterion=crit, server_policy=pol, jobs_per_queue=2,
                    seed=seed, batched=True, async_epochs=async_epochs,
                    preemption=True, tenancy=tenancy)
    g = metrics.GrantLogHook()
    sim = SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                        cfg, hooks=[g])
    r = sim.run()
    return {"makespan": r.makespan, "grants": g.grants,
            "revoked": g.revoked,
            "durations": {k: list(map(float, v))
                          for k, v in r.job_durations.items()}}


@pytest.mark.parametrize("crit,pol", (("drf", "rrr"), ("psdsf", "pooled")))
@pytest.mark.parametrize("async_epochs", (False, True))
def test_sim_zero_config_tenancy_matches_plain_preemption(crit, pol,
                                                          async_epochs):
    """Full simulator runs (sync AND async begin/commit): routing arrivals
    through the admission queue with a zero-floor no-spend control plane
    reproduces the plain preemption-on traces bit-for-bit — the gate
    admits every arrival at the head of the epoch that would have seen it
    anyway, and accrual touches no allocation input."""
    assert _sim_fingerprint(crit, pol, tenancy=None,
                            async_epochs=async_epochs) == \
        _sim_fingerprint(crit, pol, tenancy=TenancyConfig(),
                         async_epochs=async_epochs)


# ---------------------------------------------------------------------------
# durability: checkpoint/restore + auditor
# ---------------------------------------------------------------------------

def _busy_tenancy_alloc():
    al = _alloc(tenancy=TenancyConfig(floors=(("a", 0.25),),
                                      max_admissions_per_epoch=2),
                preemption=PreemptionPolicy())
    for i in range(5):
        al.submit_admission(f"f{i}", demand=(1.0, 1.0), wanted_tasks=2,
                            tenant="a" if i % 2 else "b", now=float(i))
    al.allocate()
    al.allocate()
    al.tenancy.accrue("b", 4.0)
    if al.tenancy.queue:
        try:
            al.spend_queue_jump(al.tenancy.queue[0].fid)
        except ValueError:
            pass
    return al


def test_checkpoint_restore_roundtrips_control_plane():
    ref = _busy_tenancy_alloc()
    snap = ref.checkpoint()
    rec = OnlineAllocator(2, criterion="drf", server_policy="pooled",
                          seed=0, preemption=PreemptionPolicy(),
                          tenancy=TenancyConfig())
    rec.restore(snap)
    assert invariants.recovery_parity(ref, rec) == []
    assert rec.epoch_counter == ref.epoch_counter
    assert rec.tenancy.state_dict() == ref.tenancy.state_dict()
    # the restored allocator keeps serving: same next epoch
    assert [(g.fid, g.agent) for g in ref.allocate()] == \
        [(g.fid, g.agent) for g in rec.allocate()]


def test_restore_tenancy_checkpoint_needs_control_plane():
    snap = _busy_tenancy_alloc().checkpoint()
    bare = OnlineAllocator(2, criterion="drf", server_policy="pooled",
                           seed=0, preemption=PreemptionPolicy())
    with pytest.raises(ValueError, match="tenancy"):
        bare.restore(snap)


def test_auditor_green_after_every_admission_grant_revoke():
    """Satellite contract: the PR-8 invariant auditor passes after every
    control-plane mutation in a churn scenario that exercises admission,
    granting, floors and revocation."""
    al = _alloc(tenancy=TenancyConfig(floors=(("inc", 0.25),)))
    al.submit_admission("inc-0", demand=(1.0, 1.0), wanted_tasks=8,
                        tenant="inc")
    assert invariants.check(al) == []
    al.allocate()
    assert invariants.check(al) == []
    al.submit_admission("new-0", demand=(2.0, 2.0), wanted_tasks=2,
                        tenant="new")
    assert invariants.check(al) == []
    al.allocate()
    assert al.last_revocations
    assert invariants.check(al) == []
    al.deregister("new-0")
    assert invariants.check(al) == []


def test_auditor_flags_credit_drift():
    al = _busy_tenancy_alloc()
    al.tenancy.credits["b"] += 1.0        # corrupt: balance != accrued-spent
    assert any("credit" in v for v in invariants.check(al))


def test_auditor_flags_fid_both_queued_and_registered():
    al = _alloc()
    al.submit_admission("f0", demand=(1.0, 1.0))
    al.register("f0", demand=(1.0, 1.0), wanted_tasks=1)   # bypasses gate
    assert any("queued" in v for v in invariants.check(al))


def test_auditor_flags_negative_balance():
    al = _alloc()
    al.tenancy.credits["t"] = -1.0
    al.tenancy.accrued["t"] = 0.0
    al.tenancy.spent["t"] = 1.0
    assert any("negative" in v for v in invariants.check(al))


# ---------------------------------------------------------------------------
# simulator + metrics integration
# ---------------------------------------------------------------------------

def test_sim_with_tenancy_records_per_tenant_metrics():
    cfg = SimConfig(criterion="drf", server_policy="rrr", jobs_per_queue=2,
                    seed=0, batched=True, preemption=True,
                    tenancy=TenancyConfig(floors=(("Pi", 0.25),)))
    hook = metrics.TenancyHook()
    sim = SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI, "WordCount": WC},
                        cfg, hooks=[hook])
    sim.run()
    s = hook.summary()
    assert s["counters"]["admission_admitted_total"] > 0
    assert set(s["admission"]) == {"Pi", "WordCount"}
    assert set(s["slo_attainment"]) == {"Pi", "WordCount"}
    assert 0.0 < s["tenant_jain_tw_mean"] <= 1.0
    assert invariants.check(sim.alloc) == []


def test_tenancy_hook_inert_without_control_plane():
    cfg = SimConfig(criterion="drf", server_policy="rrr", jobs_per_queue=1,
                    seed=0, batched=True)
    hook = metrics.TenancyHook()
    SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": PI}, cfg, hooks=[hook]).run()
    assert hook.summary() == {}


def test_jobspec_tenant_field_routes_the_lane():
    import dataclasses as dc

    spec = dc.replace(PI, tenant="lane-x")
    cfg = SimConfig(criterion="drf", server_policy="rrr", jobs_per_queue=1,
                    seed=0, batched=True, tenancy=TenancyConfig())
    sim = SparkMesosSim(HETEROGENEOUS_AGENTS, {"Pi": spec}, cfg)
    sim.run()
    assert set(sim.alloc.tenancy.tenant_of.values()) == {"lane-x"}


# ---------------------------------------------------------------------------
# alloc_serve: per-tenant lanes
# ---------------------------------------------------------------------------

def test_serve_routes_new_fids_through_admission():
    from repro_torch.launch.alloc_serve import AllocatorService, AllocRequest

    svc = AllocatorService(2, [("a0", (8.0, 8.0))], device="cpu",
                           epoch_cache=False,
                           preemption=PreemptionPolicy(),
                           tenancy=TenancyConfig())
    svc.submit(AllocRequest(fid="f0", demand=(1.0, 1.0), n_executors=2,
                            tenant="acme"))
    grants = svc.drain_epoch()
    assert {g.fid for g in grants} == {"f0"}
    assert svc.alloc.tenancy.tenant_of["f0"] == "acme"
    h = svc.health()
    assert h["admissions"]["admission_admitted_total"] == 1


def test_serve_coalesces_duplicate_queued_fid():
    from repro_torch.launch.alloc_serve import AllocatorService, AllocRequest

    svc = AllocatorService(2, [("a0", (8.0, 8.0))], epoch_cache=False,
                           tenancy=TenancyConfig(), device="cpu")
    svc.submit(AllocRequest(fid="f0", demand=(1.0, 1.0), n_executors=1))
    svc.submit(AllocRequest(fid="f0", demand=(1.0, 1.0), n_executors=1))
    svc.drain_epoch()
    assert svc.coalesced_admissions == 1
    assert svc.alloc.tenancy.counters()["admission_enqueued_total"] == 1


def test_multi_tenant_smoke_end_to_end(tmp_path):
    from repro_torch.launch import alloc_serve

    out = tmp_path / "admission_stats.json"
    stats = alloc_serve.multi_tenant_smoke(str(out), rounds=12,
                                         device="cpu")
    assert out.exists()
    assert stats["admissions"]["admission_admitted_total"] > 0
    assert stats["ledger_invariants"] == "green"
