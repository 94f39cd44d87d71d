"""Multi-tenant control plane: admission queues, quota floors, credits.

The paper's schedulers (and the :mod:`repro.core.online` allocator built on
them) are fair over *granted* demand: a framework that registers is
immediately part of every epoch.  At fleet scale that is the wrong boundary
— Tromino (arXiv 1905.08387) puts a demand- and DRF-aware queue manager in
FRONT of the Mesos allocator, and Saha et al. (arXiv 1905.08388) document
the starvation pathologies that motivate it.  This module is that front
door: a control plane sitting between workload arrivals and
:class:`~repro.core.online.OnlineAllocator`, owned by the allocator as
``allocator.tenancy`` and journaled through the allocator's write-ahead
journal so recovery replays it bit-for-bit.

Three mechanisms, each inert unless configured:

Admission queues (demand-aware ordering)
----------------------------------------
``OnlineAllocator.submit_admission`` enqueues an arrival instead of
registering it; the **admission gate** at the top of every allocation epoch
(before the preemption pass and the journal bracket) drains the queue in
*dominant-share-over-queued-demand* order — Tromino's queue-manager shape:

    score(entry) = tenant's current aggregate dominant share
                   / max(entry's queued dominant demand, eps)

ascending, so tenants holding little relative to what they ask for go
first; brand-new tenants score 0 and admit in arrival order.  Credit-jumped
entries precede everything; all ties resolve by arrival sequence.  The
ordering consumes NO rng — for a fixed arrival history it is deterministic
(property-gated in ``tests/test_tenancy.py``).

Quota floors (firm-up-to-floor, independent of membership)
----------------------------------------------------------
``TenancyConfig.floors`` maps tenants to a fraction of pooled cluster
capacity.  A tenant with ``floor > 0`` swaps the phi-weighted fair-share
revocability rule for an *absolute* one: a grant is FIRM while the tenant's
aggregate unweighted dominant share stays at or under its floor, REVOCABLE
above it — **independent of who else is registered**.  This fixes the
known lone-tenant gap: under the membership-relative rule a framework alone
on the cluster is never over its fair share, so all its grants are firm
and later arrivals wait out its holdings; with a floor its above-floor
holdings are revocable from the start, and the preemption pass (which
victimizes above-floor holders by the same rule) hands the excess to the
newcomer.  Symmetrically, no tenant at or below its floor is ever a
preemption victim (property-gated).  ``floor = 0`` (the default) keeps the
fair-share rule bit-for-bit.

Credit ledger
-------------
Tenants accrue ``credit_accrual`` credits per allocation epoch while their
aggregate share sits under the equal split across active tenants, and spend
them explicitly (never automatically — an empty ledger plus floors=0 is
bit-for-bit plain preemption):

  * ``OnlineAllocator.spend_queue_jump(fid)`` — marks a queued entry
    *jumped*: it admits ahead of every non-jumped entry;
  * ``OnlineAllocator.spend_shield(tenant)`` — shields the tenant's
    revocable grants from the preemption pass for ``shield_epochs``
    allocation epochs.

The conservation invariant ``accrued - spent == balance`` (per tenant) is
enforced by :func:`repro.core.invariants.check` whenever a control plane is
attached.

Durability
----------
Every control-plane mutation is a journaled record — ``admit-enqueue``
(arrival enters the queue), ``admit`` (ONE atomic record per gate run
listing every admitted fid: replay dequeues AND re-registers from the
queued entries, and no separate ``fw-register`` records are written, so a
torn tail can never separate an admission from its framework), ``credit``
(accrual/spend with ABSOLUTE post-op balances, so replay is
order-independent and bit-exact).  All three land OUTSIDE the epoch
bracket (the gate runs before ``_journal_begin``), so recovery applies
them eagerly exactly where the live run did; the ``last_gate_epoch`` /
``last_accrued_epoch`` watermarks then make the re-run of a dangling
(uncommitted) epoch skip the gate and the accrual it already replayed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """Configuration of the multi-tenant control plane.

    floors
        ``((tenant, floor_fraction), ...)`` — per-tenant quota floors as a
        fraction of pooled dominant capacity.  Tenants not listed get
        ``default_floor``.
    default_floor
        Floor for unlisted tenants (0.0 = the membership-relative
        fair-share rule, bit-for-bit the plain preemption behaviour).
    credit_accrual
        Credits accrued per allocation epoch by every tenant under the
        equal split across active tenants (0 disables the ledger).
    queue_jump_cost / shield_cost
        Credit price of an admission-queue jump / a revocation shield.
    shield_epochs
        Epochs a shield protects the tenant's revocable grants for.
    max_admissions_per_epoch
        Gate budget per epoch (None = drain the whole queue).
    eps
        Share/balance comparison tolerance.
    """

    floors: tuple = ()
    default_floor: float = 0.0
    credit_accrual: float = 1.0
    queue_jump_cost: float = 8.0
    shield_cost: float = 16.0
    shield_epochs: int = 4
    max_admissions_per_epoch: Optional[int] = None
    eps: float = 1e-9

    def floor_of(self, tenant: str) -> float:
        for t, f in self.floors:
            if t == tenant:
                return float(f)
        return float(self.default_floor)


@dataclasses.dataclass
class AdmissionEntry:
    """One queued arrival (the pre-registration half of a framework)."""

    seq: int                 # arrival sequence number (total order)
    fid: str
    tenant: str
    demand: Optional[np.ndarray]
    wanted: int
    phi: float
    allowed: Optional[tuple]
    t_enqueue: float         # caller clock (simulator virtual time)
    jumped: bool = False     # credit-purchased queue jump


class ControlPlane:
    """Runtime state of the tenancy control plane (one per allocator).

    Pure bookkeeping: every decision input (tenant shares, pooled
    capacity, the epoch counter) is supplied by the owning allocator, and
    every mutation is journaled BY the allocator — this class never
    touches the journal or the cluster state itself.
    """

    def __init__(self, cfg: TenancyConfig):
        self.cfg = cfg
        self.queue: list[AdmissionEntry] = []
        self.arrival_seq = 0
        self.tenant_of: dict[str, str] = {}     # fid -> tenant (sticky)
        self.credits: dict[str, float] = {}     # tenant -> balance
        self.accrued: dict[str, float] = {}     # tenant -> lifetime accrual
        self.spent: dict[str, float] = {}       # tenant -> lifetime spend
        self.shield_until: dict[str, int] = {}  # tenant -> last shielded epoch
        # highest epoch whose accrual has been applied — makes accrual
        # idempotent per epoch, so a recovery that replayed an accrue
        # record and then RE-RUNS its (uncommitted) epoch does not accrue
        # twice (the record lands outside the epoch bracket; the dangling
        # bracket itself recovers as never-begun).
        self.last_accrued_epoch = -1
        # highest epoch whose admission gate has been applied — same
        # idempotency role as ``last_accrued_epoch``: a recovery that
        # replayed an (outside-bracket) admit record and then re-runs the
        # dangling epoch must not drain the queue a second time.
        self.last_gate_epoch = -1
        self.enqueued_total = 0
        self.admitted_total = 0
        self.jumps_total = 0
        self.shields_total = 0

    # -- queue ---------------------------------------------------------------

    def has_queued(self, fid: str) -> bool:
        return any(e.fid == fid for e in self.queue)

    def find_queued(self, fid: str) -> AdmissionEntry:
        for e in self.queue:
            if e.fid == fid:
                return e
        raise KeyError(f"{fid!r} is not queued for admission")

    def enqueue(self, fid: str, tenant: str, demand, wanted: int,
                phi: float, allowed, t_enqueue: float,
                seq: Optional[int] = None) -> AdmissionEntry:
        if seq is None:
            seq = self.arrival_seq
        entry = AdmissionEntry(
            seq=seq, fid=fid, tenant=tenant,
            demand=None if demand is None else np.asarray(demand, np.float64),
            wanted=int(wanted), phi=float(phi),
            allowed=None if allowed is None else tuple(sorted(allowed)),
            t_enqueue=float(t_enqueue))
        self.arrival_seq = max(self.arrival_seq, seq) + 1
        self.queue.append(entry)
        self.tenant_of[fid] = tenant
        self.enqueued_total += 1
        return entry

    def admission_order(self, tenant_shares: dict,
                        ctot: Optional[np.ndarray]) -> list[AdmissionEntry]:
        """Queue in admission order: jumped entries first, then ascending
        dominant-share-over-queued-demand score, ties by arrival seq.
        Deterministic — consumes no rng (see the module docstring)."""
        eps = max(self.cfg.eps, 1e-30)

        def dshare(e: AdmissionEntry) -> float:
            if e.demand is None or ctot is None:
                return 0.0
            d = e.demand * max(e.wanted, 1)
            return float(np.max(d / np.maximum(ctot, 1e-30)))

        def key(e: AdmissionEntry):
            score = tenant_shares.get(e.tenant, 0.0) / max(dshare(e), eps)
            return (0 if e.jumped else 1, score, e.seq)

        return sorted(self.queue, key=key)

    def dequeue(self, fid: str) -> AdmissionEntry:
        entry = self.find_queued(fid)
        self.queue.remove(entry)
        self.admitted_total += 1
        return entry

    # -- credits -------------------------------------------------------------

    def balance(self, tenant: str) -> float:
        return self.credits.get(tenant, 0.0)

    def accrue(self, tenant: str, amount: float) -> None:
        self.credits[tenant] = self.credits.get(tenant, 0.0) + amount
        self.accrued[tenant] = self.accrued.get(tenant, 0.0) + amount

    def spend(self, tenant: str, amount: float) -> None:
        if self.balance(tenant) + self.cfg.eps < amount:
            raise ValueError(
                f"tenant {tenant!r} has {self.balance(tenant):.3f} credits, "
                f"needs {amount:.3f}")
        self.credits[tenant] = self.credits.get(tenant, 0.0) - amount
        self.spent[tenant] = self.spent.get(tenant, 0.0) + amount

    def shield_active(self, tenant: str, epoch: int) -> bool:
        return epoch <= self.shield_until.get(tenant, -1)

    # -- durability ----------------------------------------------------------

    def credit_state(self) -> dict:
        """Absolute ledger maps for a ``credit`` journal record / snapshot."""
        return {"credits": dict(self.credits),
                "accrued": dict(self.accrued),
                "spent": dict(self.spent),
                "shield": dict(self.shield_until),
                "accrue_epoch": self.last_accrued_epoch}

    def restore_credit_state(self, maps: dict) -> None:
        self.credits = {k: float(v) for k, v in maps["credits"].items()}
        self.accrued = {k: float(v) for k, v in maps["accrued"].items()}
        self.spent = {k: float(v) for k, v in maps["spent"].items()}
        self.shield_until = {k: int(v) for k, v in maps["shield"].items()}
        self.last_accrued_epoch = int(maps.get("accrue_epoch", -1))

    def state_dict(self) -> dict:
        """Full control-plane state for :meth:`OnlineAllocator.checkpoint`."""
        return {
            "queue": [{
                "seq": e.seq, "fid": e.fid, "tenant": e.tenant,
                "demand": None if e.demand is None else e.demand.tolist(),
                "wanted": e.wanted, "phi": e.phi,
                "allowed": None if e.allowed is None else list(e.allowed),
                "t_enqueue": e.t_enqueue, "jumped": e.jumped,
            } for e in self.queue],
            "arrival_seq": self.arrival_seq,
            "tenant_of": dict(self.tenant_of),
            **self.credit_state(),
            "counters": [self.enqueued_total, self.admitted_total,
                         self.jumps_total, self.shields_total],
            "gate_epoch": self.last_gate_epoch,
        }

    def restore_state(self, payload: dict) -> None:
        self.queue = [AdmissionEntry(
            seq=int(q["seq"]), fid=q["fid"], tenant=q["tenant"],
            demand=(None if q["demand"] is None
                    else np.asarray(q["demand"], np.float64)),
            wanted=int(q["wanted"]), phi=float(q["phi"]),
            allowed=None if q["allowed"] is None else tuple(q["allowed"]),
            t_enqueue=float(q["t_enqueue"]), jumped=bool(q["jumped"]),
        ) for q in payload["queue"]]
        self.arrival_seq = int(payload["arrival_seq"])
        self.tenant_of = dict(payload["tenant_of"])
        self.restore_credit_state(payload)
        (self.enqueued_total, self.admitted_total,
         self.jumps_total, self.shields_total) = map(int, payload["counters"])
        self.last_gate_epoch = int(payload.get("gate_epoch", -1))

    def counters(self) -> dict:
        """Telemetry counters (surfaced by ``alloc_serve.health()``)."""
        return {
            "admission_queued": len(self.queue),
            "admission_enqueued_total": self.enqueued_total,
            "admission_admitted_total": self.admitted_total,
            "credit_jumps": self.jumps_total,
            "credit_shields": self.shields_total,
            "credit_balances": {t: round(v, 9)
                                for t, v in sorted(self.credits.items())},
        }


def get_control_plane(spec) -> Optional[ControlPlane]:
    """Resolve a tenancy spec: None | True | TenancyConfig | ControlPlane."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return ControlPlane(TenancyConfig())
    if isinstance(spec, TenancyConfig):
        return ControlPlane(spec)
    if isinstance(spec, ControlPlane):
        return spec
    raise ValueError(f"unknown tenancy spec {spec!r}")
