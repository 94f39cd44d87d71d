"""Online (Mesos-style) fair allocator.

Implements the paper's Section 3 allocator semantics on top of the shared
criterion module :mod:`repro.core.criteria`:

  * **workload-characterized ("fine-grained")** — each framework declares its
    per-task demand vector d_n; every allocation epoch hands out single-task
    bundles, choosing the framework by the configured criterion and the agent
    by the configured server policy (RRR / pooled / best-fit).
  * **oblivious ("coarse-grained")** — demands are NOT declared; the allocator
    scores frameworks on *inferred* demands (aggregate usage / #grants) and
    offers the visited agent's ENTIRE free resources; the framework carves as
    many executors as fit (capped by what it still wants) and returns the rest.

Shared semantics (paper §3.1):
  * newly-arrived frameworks (zero allocation) are naturally prioritized: all
    criteria score them 0;
  * on release (job completion / agent failure) the freed resources re-enter
    the pool and a new epoch runs;
  * agents can register/deregister dynamically (the paper's §3.7 one-by-one
    registration; our fault-tolerance churn).

State lives in an incremental :class:`repro.core.cluster_state.ClusterState`
(struct-of-arrays with stable slots, updated in O(R) per grant/release) —
the allocator never rebuilds matrices from Python dicts.  Two epoch paths:

  * ``allocate()`` — the legacy-compatible per-grant path: feasibility and
    scores are fully recomputed before every grant, reproducing the historic
    grant sequences bit-for-bit (golden-tested);
  * ``allocate(batched=True)`` — the fast path: one
    :class:`repro.core.engine.BatchedEpoch` computes scores/feasibility once
    per epoch and keeps them consistent with O((N+J)*R) incremental updates
    per grant, selecting through the same :mod:`repro.core.policies` strategy
    objects as the exact reference filler (parity-tested against it).

Batched epochs default to ``use_kernel="auto"``: the backend (numpy
incremental vs the fused device epoch of :mod:`repro.core.engine_jax`) is
picked from (N, J, jax backend) against the crossover measured in
``benchmarks/allocator_bench.py`` (``engine.AUTO_KERNEL_MIN_CELLS``), so
small clusters never pay a device dispatch and fleet-scale epochs never run
the host loop.

Revocable offers & preemption (:mod:`repro.core.preemption`): with a
``preemption=PreemptionPolicy(...)`` the allocator classifies every grant at
grant time — grants made while the framework stays under its phi-weighted
fair share (``criteria.fair_share_level``) are FIRM, grants that push it
over are REVOCABLE (tracked in ``ClusterState.Xr``) — and every allocation
epoch starts with a preemption pass: when a starved under-share framework's
demand fits no allowed agent, revocable executors of the most-over-share
frameworks (victim order = the shared criterion scores, max first) are
revoked one at a time until the starved framework fits.  The pass runs
BEFORE the grant loop on every path (per-grant, batched, fused device,
async begin/commit), so revoke+grant sequences are engine-independent;
revocations of an epoch are surfaced in :attr:`last_revocations` (and on
the ``InFlightEpoch``).  Characterized mode only.

Asynchronous epochs (the double-buffered pipeline): :meth:`begin_epoch`
freezes the epoch inputs into an immutable upload view
(``ClusterState.epoch_view``) and dispatches the fused device epoch WITHOUT
blocking on the grant-sequence readback; :meth:`commit_epoch` blocks, runs
the f64 re-validation and applies the grants incrementally — bit-for-bit
the sequence the synchronous path produces, because the synchronous path
*is* ``commit_epoch(begin_epoch(...))`` back to back.  Between begin and
commit the live ClusterState may serve reads, but mutating it invalidates
the in-flight (device) epoch and is refused at commit (a ``mutation_count``
guard), and only one epoch may be in flight per allocator: the caller owns
the commit point.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.core import criteria
from repro_torch.core import epoch_cache as _epoch_cache
from repro_torch.core import faults as _faults
from repro_torch.core import invariants as _invariants
from repro_torch.core import journal as _journal
from repro_torch.core import preemption as _preemption
from repro_torch.core import tenancy as _tenancy
from repro_torch.core.cluster_state import ClusterState, StateView
from repro_torch.core.engine import (
    AUTO_KERNEL_FLOOR_CELLS,
    AUTO_KERNEL_MIN_CELLS,
    AUTO_MESH_MIN_CELLS,
    AUTO_SHARD_MIN_CELLS,
    BatchedEpoch,
)
from repro_torch.kernels import KernelError


class AllocSnapshot(NamedTuple):
    """Read-only telemetry snapshot of the allocator (see :meth:`snapshot`).

    ``cap_total``/``free_total`` are ``None`` when no agents are registered.
    This is the hook point :mod:`repro.core.metrics` consumes — metrics code
    never reaches into allocator internals."""

    fids: tuple              # registered frameworks, registration order
    usage: np.ndarray        # (N, R) held resources (executors + slack)
    phi: np.ndarray          # (N,) priority weights
    cap_total: Optional[np.ndarray]   # (R,) pooled cluster capacity
    free_total: Optional[np.ndarray]  # (R,) pooled free resources


@dataclasses.dataclass
class FrameworkState:
    fid: str
    demand: Optional[np.ndarray]        # declared per-task demand (characterized)
    wanted_tasks: int                   # executors the framework still wants
    usage: np.ndarray                   # (R,) aggregate allocated resources
    tasks: dict                         # agent -> list[np.ndarray] bundles
    slack: dict = dataclasses.field(default_factory=dict)  # agent -> (R,) held-but-unused (coarse offers)
    grants: int = 0                     # number of accepted offers
    phi: float = 1.0                    # priority weight
    allowed_agents: Optional[set] = None  # placement constraints (None = any)
    revocable: dict = dataclasses.field(default_factory=dict)  # agent -> count

    @property
    def n_tasks(self) -> int:
        return sum(len(v) for v in self.tasks.values())

    def inferred_demand(self) -> Optional[np.ndarray]:
        if self.demand is not None:
            return self.demand
        n = self.n_tasks
        return None if n == 0 else self.usage / n


@dataclasses.dataclass
class Grant:
    fid: str
    agent: str
    bundle: np.ndarray          # resources handed over
    n_executors: int            # executors the framework carved out of it
    revocable: bool = False     # pushed the framework over its fair share
                                # (preemption enabled only; see preemption.py)


@dataclasses.dataclass
class InFlightEpoch:
    """A double-buffered allocation epoch (see :meth:`OnlineAllocator.begin_epoch`).

    ``view``/``TD`` are the frozen upload snapshot the epoch scores from;
    ``handle`` is the in-flight device work (``engine_jax.EpochHandle``).
    When the configuration cannot run on the fused device path the epoch
    falls back to the host engine at begin time and ``grants`` carries the
    already-applied result — ``commit_epoch`` then just returns it, so
    callers drive both paths identically."""

    view: Optional[StateView]
    TD: Optional[np.ndarray]
    per_agent_limit: Optional[int]
    handle: Optional[object] = None     # engine_jax.EpochHandle (fused path)
    grants: Optional[list] = None       # host fallback: applied at begin
    guard: int = 0                      # ClusterState.mutation_count at begin
    consumed: bool = False
    revocations: list = dataclasses.field(default_factory=list)
    # ^ the epoch's preemption-pass output: revocations happen at BEGIN time
    #   (before the view freeze / device dispatch), the caller learns them
    #   here so async consumers can apply kill effects at the commit point.
    cached_seq: Optional[tuple] = None  # epoch-cache HIT on a fused-path
    #   config: the precomputed grant sequence, replayed at commit under the
    #   same staleness guard / f64 re-validation as a device readback.
    cache_key: Optional[bytes] = None   # epoch-cache MISS: fingerprint to
    #   populate at commit (device paths) — host misses store at begin.
    perm_rows0: int = 0                 # RRR permutation-prefix height drawn
    #   before dispatch (cache enabled): commit records only the
    #   grow-and-replay rows PAST it in the stored outcome.
    rng_state0: Optional[dict] = None   # allocator rng state BEFORE any of
    #   this epoch's draws: abort/recovery rewinds to it so the stream is
    #   exactly where it would be had the epoch never begun (and a host
    #   re-run of a failed fused epoch draws the identical sequence).
    tie: str = "low"                    # epoch knobs kept for recovery
    shards: int = 1                     #   re-dispatch (commit-time retry
    devices: int = 1                    #   of a failed device readback).

    @property
    def in_flight(self) -> bool:
        return ((self.handle is not None or self.cached_seq is not None)
                and not self.consumed)


class OnlineAllocator:
    """Offer-based fair allocator over a dynamic pool of agents."""

    def __init__(
        self,
        n_resources: int,
        criterion="drf",                 # name or criteria.Criterion
        server_policy: str = "rrr",
        mode: str = "characterized",     # characterized | oblivious
        bf_metric: str = "cosine",
        seed: int = 0,
        preemption=None,                 # None | True | PreemptionPolicy
        epoch_cache=None,                # None | True | bytes | EpochCache
        recovery=None,                   # None | RecoveryPolicy (faults.py)
        fault_injector=None,             # faults.EngineFaultInjector (chaos)
        audit: bool = False,             # run invariants.py after epochs
        tenancy=None,                    # None | True | TenancyConfig | ControlPlane
        device="cuda",                   # torch device of the fused epoch
    ):
        if mode not in ("characterized", "oblivious"):
            raise ValueError(mode)
        if server_policy not in ("rrr", "pooled", "bestfit"):
            raise ValueError(f"unknown server policy {server_policy!r}")
        self.preemption = _preemption.get_policy(preemption)
        if self.preemption is not None and mode != "characterized":
            raise ValueError("preemption requires characterized mode: the "
                             "oblivious allocator cannot detect starvation "
                             "(no true demands) and coarse offers free "
                             "slack via deregistration, not revocation")
        from repro_torch.core import engine_torch

        #: where fused epochs run; "cuda" without a card raises here
        self.device = engine_torch.resolve_device(device)
        self.R = n_resources
        self.crit = criteria.get_criterion(criterion)
        self.criterion = self.crit.name
        self.server_policy = server_policy
        self.mode = mode
        self.bf_metric = bf_metric
        self.rng = np.random.default_rng(seed)
        self.state = ClusterState(n_resources)
        #: content-addressed precomputed-epoch cache (None = disabled);
        #: may be an instance SHARED across allocators (see epoch_cache.py)
        self.epoch_cache = _epoch_cache.get_cache(epoch_cache)
        self.frameworks: dict[str, FrameworkState] = {}
        self._inflight_epoch: Optional[InFlightEpoch] = None
        self._fair_cache = None   # (state._version, ctot, level) memo
        #: revocations of the most recent allocation epoch's preemption pass
        self.last_revocations: list = []
        #: multi-tenant control plane (repro.core.tenancy; None = off —
        #: submit_admission/spend_* are refused and every epoch path is
        #: bit-for-bit the pre-tenancy behaviour)
        self.tenancy = _tenancy.get_control_plane(tenancy)
        #: allocation-epoch counter: ticks once per epoch that has work
        #: (frameworks AND agents registered — exactly the epochs that
        #: open a journal bracket), journaled in epoch-begin records so
        #: recovery restores it bit-exactly.  Drives revocation hysteresis
        #: and credit shields.
        self.epoch_counter = 0
        #: (fid, agent) -> epoch of the pair's NEWEST grant (preemption
        #: enabled only) — the revocation-hysteresis freshness ledger.
        self._grant_epoch: dict = {}
        #: (fid, tenant, t_enqueue) admissions of recent epochs, drained
        #: by the simulator for admission-latency hooks (telemetry only —
        #: not part of the durable state).
        self.last_admissions: list = []
        # -- self-healing dispatch (repro.core.faults; docs/robustness.md) --
        #: retry/backoff/quarantine knobs
        self.recovery = _faults.get_recovery(recovery)
        #: chaos: injected device-dispatch errors (None = no injection)
        self.fault_injector = fault_injector
        #: consecutive-failure tracking + device-path quarantine state
        self.device_health = _faults.DeviceHealth(
            quarantine_after=self.recovery.quarantine_after,
            probe_every=self.recovery.probe_every)
        #: fault/recovery counters (see fault_counters())
        self.fault_stats = _faults.FaultStats()
        #: callables (kind: str, info: dict) -> None notified on every
        #: fault/recovery event — the simulator forwards these to the
        #: metrics SimHook.on_fault/on_recovery callbacks
        self.fault_listeners: list = []
        #: run the ledger invariant auditor after every epoch (chaos mode)
        self.audit = bool(audit)
        #: attached write-ahead journal (repro.core.journal; None = off).
        #: Attach BEFORE adding agents/frameworks, or pair the attachment
        #: with a snapshot — replay starts from what the journal (or its
        #: covering snapshot) saw, never from mid-history.
        self.journal: Optional[_journal.Journal] = None

    # -- fault/recovery surface (repro.core.faults) --------------------------

    def _notify_fault(self, kind: str, **info) -> None:
        for cb in self.fault_listeners:
            cb(kind, info)
        if self.journal is not None:
            # fault/quarantine transitions are durable: recovery restores
            # the counters and quarantine state the crashed process held.
            self.journal.append({
                "t": _journal.FAULT_STATE, "kind": kind,
                "fault": self.fault_stats.as_dict(),
                "health": self.device_health.state_dict()})

    def fault_counters(self) -> dict:
        """Merged fault/recovery counters: FaultStats + device health +
        (when installed) the injector's injection counts."""
        out = self.fault_stats.as_dict()
        out["epochs_aborted"] = self.fault_stats.epoch_aborts
        out.update(self.device_health.counters())
        if self.fault_injector is not None:
            out.update(self.fault_injector.counters())
        return out

    # -- durability (repro.core.journal) -------------------------------------

    def _journal_rec(self, rec: dict) -> None:
        if self.journal is not None:
            self.journal.append(rec)

    def _journal_begin(self, engine: str, per_agent_limit, rng_state0,
                       view=None, TD=None, tie: str = "low") -> None:
        """Open an epoch bracket in the journal: the PR-7 frozen-view
        fingerprint (b"" for the per-grant path, which has no frozen view)
        plus the pre-draw rng state recovery rewinds to if this epoch never
        commits."""
        if self.journal is None:
            return
        fp = b""
        if view is not None:
            fp = _epoch_cache.EpochCache.fingerprint(
                view, TD, criterion=self.criterion,
                policy=self.server_policy, mode=self.mode, tie=tie,
                engine=engine, per_agent_limit=per_agent_limit,
                bf_metric=self.bf_metric)
        self.journal.append({
            "t": _journal.EPOCH_BEGIN, "engine": engine, "fp": fp,
            "pal": per_agent_limit, "rng_state0": rng_state0,
            "epoch": self.epoch_counter})

    def _journal_commit(self, grants: list) -> None:
        """Close the open epoch bracket: grant-sequence digest (recovery
        cross-checks it against the replayed grant records), the POST-epoch
        rng state (replay fast-forwards instead of re-drawing) and the
        final fault/quarantine counters."""
        if self.journal is None:
            return
        self.journal.append({
            "t": _journal.EPOCH_COMMIT,
            "rng_state": self.rng.bit_generator.state,
            "n_grants": len(grants),
            "seq_digest": _journal.grant_digest(
                (g.fid, g.agent) for g in grants),
            "fault": self.fault_stats.as_dict(),
            "health": self.device_health.state_dict()})

    def _journal_abort(self) -> None:
        """Close the open epoch bracket as aborted (rng already rewound)."""
        if self.journal is None:
            return
        self.journal.append({
            "t": _journal.EPOCH_ABORT,
            "rng_state": self.rng.bit_generator.state,
            "fault": self.fault_stats.as_dict(),
            "health": self.device_health.state_dict()})

    def checkpoint(self) -> dict:
        """Serialize the full allocator state for bit-exact restore.

        Raw ledger arrays (ClusterState payload), per-framework bundle
        ledgers, the rng state and the fault/quarantine counters — nothing
        is re-derived at restore time, so no float accumulation reruns (see
        the journal module docstring).  Refused while an epoch is in
        flight: commit or abort it first (the snapshot would otherwise
        capture rng draws whose epoch never happened)."""
        if self._inflight_epoch is not None:
            raise RuntimeError("cannot checkpoint with an epoch in flight; "
                               "commit_epoch() or abort_epoch() it first")
        fws = {}
        for fid, fw in self.frameworks.items():
            fws[fid] = {
                "demand": None if fw.demand is None else fw.demand.copy(),
                "wanted_tasks": fw.wanted_tasks,
                "usage": fw.usage.copy(),
                "tasks": {a: [b.copy() for b in bs]
                          for a, bs in fw.tasks.items()},
                "slack": {a: s.copy() for a, s in fw.slack.items()},
                "grants": fw.grants,
                "phi": fw.phi,
                "allowed_agents": (None if fw.allowed_agents is None
                                   else sorted(fw.allowed_agents)),
                "revocable": dict(fw.revocable),
            }
        return {
            "format": "alloc-ckpt-v1",
            "R": self.R, "criterion": self.criterion,
            "server_policy": self.server_policy, "mode": self.mode,
            "bf_metric": self.bf_metric,
            "rng_state": self.rng.bit_generator.state,
            "state": self.state.to_payload(),
            "frameworks": fws,
            "fault": self.fault_stats.as_dict(),
            "health": self.device_health.state_dict(),
            "epoch_counter": self.epoch_counter,
            "grant_epochs": [[f, a, e]
                             for (f, a), e in self._grant_epoch.items()],
            "tenancy": (None if self.tenancy is None
                        else self.tenancy.state_dict()),
        }

    def restore(self, payload: dict) -> None:
        """Overwrite this allocator's state from a :meth:`checkpoint`.

        The allocator must have been constructed with the identical
        configuration — restoring a checkpoint into a different criterion/
        policy/mode would silently change every future grant, so a
        mismatch raises instead."""
        if payload.get("format") != "alloc-ckpt-v1":
            raise ValueError(f"unknown checkpoint format "
                             f"{payload.get('format')!r}")
        for k in ("R", "criterion", "server_policy", "mode", "bf_metric"):
            if payload[k] != getattr(self, k):
                raise ValueError(
                    f"checkpoint {k}={payload[k]!r} does not match this "
                    f"allocator's {k}={getattr(self, k)!r}")
        self.state = ClusterState.from_payload(payload["state"])
        self.frameworks = {
            fid: FrameworkState(
                fid=fid,
                demand=(None if p["demand"] is None
                        else np.array(p["demand"])),
                wanted_tasks=p["wanted_tasks"],
                usage=np.array(p["usage"]),
                tasks={a: [np.array(b) for b in bs]
                       for a, bs in p["tasks"].items()},
                slack={a: np.array(s) for a, s in p["slack"].items()},
                grants=p["grants"], phi=p["phi"],
                allowed_agents=(None if p["allowed_agents"] is None
                                else set(p["allowed_agents"])),
                revocable=dict(p["revocable"]),
            )
            for fid, p in payload["frameworks"].items()}
        self.rng.bit_generator.state = payload["rng_state"]
        self.fault_stats.restore(payload["fault"])
        self.device_health.restore(payload["health"])
        # pre-tenancy checkpoints carry none of these keys: default to the
        # state a fresh pre-tenancy allocator would hold.
        self.epoch_counter = int(payload.get("epoch_counter", 0))
        self._grant_epoch = {(f, a): int(e)
                             for f, a, e in payload.get("grant_epochs", ())}
        ten = payload.get("tenancy")
        if ten is not None:
            if self.tenancy is None:
                raise ValueError(
                    "checkpoint carries tenancy control-plane state but "
                    "this allocator was constructed without tenancy")
            self.tenancy.restore_state(ten)
        self._inflight_epoch = None
        self._fair_cache = None
        self.last_revocations = []
        self.last_admissions = []

    # -- dict-style views (read-only; canonical data is in self.state) -------

    @property
    def agents(self) -> dict:
        """agent -> capacity (R,), in registration order.  Copies: the
        canonical arrays live in ClusterState and may be reallocated on
        growth, so handing out views would silently go stale."""
        return {a: self.state.C[j].copy()
                for a, j in self.state.agent2slot.items()}

    @property
    def free(self) -> dict:
        """agent -> free resources (R,), in registration order (copies)."""
        return {a: self.state.FREE[j].copy()
                for a, j in self.state.agent2slot.items()}

    # -- membership ---------------------------------------------------------

    def add_agent(self, name: str, capacity) -> None:
        self.state.add_agent(name, capacity)
        self._journal_rec({"t": _journal.AGENT_ADD, "name": name,
                           "cap": np.asarray(capacity, np.float64)})

    def remove_agent(self, name: str) -> list[tuple[str, int]]:
        """Remove an agent (failure). Returns [(fid, n_executors_lost)].

        Frameworks that only held coarse-offer slack on the failed agent are
        reported too (with 0 executors lost) so callers can reconcile their
        usage accounting."""
        lost = []
        for fw in self.frameworks.values():
            bundles = fw.tasks.pop(name, [])
            fw.revocable.pop(name, None)
            s = fw.slack.pop(name, None)
            if s is not None:
                fw.usage -= s
            if bundles:
                fw.usage -= np.sum(bundles, axis=0)
            if bundles or s is not None:
                lost.append((fw.fid, len(bundles)))
        self.state.remove_agent(name)
        for fid, _n in lost:
            self._sync_demand(fid)
        for key in [k for k in self._grant_epoch if k[1] == name]:
            del self._grant_epoch[key]
        self._journal_rec({"t": _journal.AGENT_REMOVE, "name": name})
        return lost

    def register(self, fid: str, demand=None, wanted_tasks: int = 1,
                 phi: float = 1.0, allowed_agents=None) -> None:
        d = None if demand is None else np.asarray(demand, np.float64)
        if self.mode == "oblivious":
            d = None  # the allocator is not told, even if the job knows
        self.frameworks[fid] = FrameworkState(
            fid=fid, demand=d, wanted_tasks=wanted_tasks,
            usage=np.zeros(self.R), tasks={}, phi=float(phi),
            allowed_agents=None if allowed_agents is None else set(allowed_agents),
        )
        if fid in self.state.fid2slot:  # re-registration replaces the slot
            self.state.remove_framework(fid)
        self.state.add_framework(fid, demand=d, phi=phi,
                                 allowed_agents=allowed_agents,
                                 wanted=wanted_tasks)
        self._journal_rec({
            "t": _journal.FW_REGISTER, "fid": fid, "demand": d,
            "wanted": wanted_tasks, "phi": float(phi),
            "allowed": (None if allowed_agents is None
                        else sorted(allowed_agents))})

    def deregister(self, fid: str) -> None:
        fw = self.frameworks.pop(fid)
        for agent, bundles in fw.tasks.items():
            j = self.state.agent2slot.get(agent)
            if j is not None:
                self.state.FREE[j] += np.sum(bundles, axis=0)
        for agent, s in fw.slack.items():
            j = self.state.agent2slot.get(agent)
            if j is not None:
                self.state.FREE[j] += s
        self.state.remove_framework(fid)
        for key in [k for k in self._grant_epoch if k[0] == fid]:
            del self._grant_epoch[key]
        self._journal_rec({"t": _journal.FW_DEREGISTER, "fid": fid})

    def release_executor(self, fid: str, agent: str) -> None:
        fw = self.frameworks[fid]
        bundle = fw.tasks[agent].pop()
        fw.usage -= bundle
        # voluntary releases drain the REVOCABLE ledger first: revocable
        # grants are the newest (over-share) ones, so a framework shedding
        # executors sheds its preemption exposure before its firm holdings.
        rev_units = 0
        if fw.revocable.get(agent, 0) > 0:
            fw.revocable[agent] -= 1
            rev_units = 1
        if agent in self.state.agent2slot:
            self.state.release(fid, agent, bundle, revocable_units=rev_units)
        self._sync_demand(fid)
        self._journal_rec({"t": _journal.RELEASE, "fid": fid,
                           "agent": agent})

    def revoke_executor(self, fid: str, agent: str):
        """Revoke one REVOCABLE executor of fid on agent (preemption).

        The mechanical half of the preemption pass — also callable directly
        (an operator forcibly reclaiming over-share resources).  REFUSED
        while an allocation epoch is in flight: a revocation mutates FREE,
        which would invalidate the frozen epoch inputs and trip the
        ``mutation_count`` guard at commit anyway — failing here, at the
        mutation, is the pinned semantics (revocations are never deferred;
        commit the epoch first, then revoke).  Returns the
        :class:`~repro.core.preemption.Revocation`."""
        if self._inflight_epoch is not None:
            raise RuntimeError(
                "revocation refused: an allocation epoch is in flight; "
                "commit_epoch() it before revoking (revocations are "
                "refused, not deferred)")
        fw = self.frameworks[fid]
        if fw.revocable.get(agent, 0) <= 0:
            raise ValueError(
                f"{fid!r} holds no revocable executors on {agent!r}")
        bundle = fw.tasks[agent].pop()
        fw.usage -= bundle
        fw.revocable[agent] -= 1
        self.state.revoke(fid, agent, bundle)
        self._sync_demand(fid)
        self._journal_rec({"t": _journal.REVOKE, "fid": fid, "agent": agent})
        return _preemption.Revocation(fid=fid, agent=agent, bundle=bundle,
                                      n_executors=1)

    def set_wanted(self, fid: str, wanted_tasks: int) -> None:
        self.frameworks[fid].wanted_tasks = wanted_tasks
        self.state.set_wanted(fid, wanted_tasks)
        self._journal_rec({"t": _journal.SET_WANTED, "fid": fid,
                           "wanted": wanted_tasks})

    def force_place(self, fid: str, agent: str, n_executors: int = 1) -> None:
        """Place executors bypassing the criterion (constructing an initial
        state, e.g. the paper's §3.7 suboptimal allocation)."""
        fw = self.frameworks[fid]
        d = self._true_demand(fid)
        bundle = d * n_executors
        j = self.state.agent2slot[agent]
        if (self.state.FREE[j] - bundle < -1e-9).any():
            raise ValueError(f"agent {agent} cannot hold {n_executors} executors of {fid}")
        self.state.grant(fid, agent, bundle, n_executors)
        fw.tasks.setdefault(agent, []).extend([d.copy()] * n_executors)
        fw.usage = fw.usage + bundle
        self._sync_demand(fid)
        self._journal_rec({"t": _journal.FORCE_PLACE, "fid": fid,
                           "agent": agent, "n": n_executors})

    # -- multi-tenant control plane (repro.core.tenancy) ----------------------

    def _require_tenancy(self) -> "_tenancy.ControlPlane":
        if self.tenancy is None:
            raise RuntimeError("no tenancy control plane attached: construct "
                               "the allocator with tenancy=TenancyConfig(...)")
        return self.tenancy

    def submit_admission(self, fid: str, demand=None, wanted_tasks: int = 1,
                         phi: float = 1.0, allowed_agents=None,
                         tenant: Optional[str] = None,
                         now: float = 0.0) -> None:
        """Queue an arrival for admission instead of registering it.

        The admission gate at the top of the next allocation epoch drains
        the queue in dominant-share-over-queued-demand order (see the
        :mod:`repro.core.tenancy` docstring) and registers the admitted
        entries through the normal :meth:`register` path.  ``tenant``
        defaults to the fid itself (every framework its own tenant);
        ``now`` is the caller's clock (simulator virtual time) and feeds
        the admission-latency metrics."""
        cp = self._require_tenancy()
        if fid in self.frameworks:
            raise ValueError(f"{fid!r} is already registered")
        if cp.has_queued(fid):
            raise ValueError(f"{fid!r} is already queued for admission")
        t = fid if tenant is None else tenant
        entry = cp.enqueue(fid=fid, tenant=t, demand=demand,
                           wanted=wanted_tasks, phi=phi,
                           allowed=allowed_agents, t_enqueue=now)
        self._journal_rec({
            "t": _journal.ADMIT_ENQUEUE, "fid": fid, "tenant": t,
            "demand": entry.demand, "wanted": entry.wanted,
            "phi": entry.phi,
            "allowed": None if entry.allowed is None else list(entry.allowed),
            "tq": entry.t_enqueue, "seq": entry.seq})

    def spend_queue_jump(self, fid: str) -> None:
        """Spend the tenant's credits to jump ``fid`` ahead of every
        non-jumped entry in the admission queue (ValueError when the
        balance is short)."""
        cp = self._require_tenancy()
        entry = cp.find_queued(fid)
        cp.spend(entry.tenant, cp.cfg.queue_jump_cost)
        entry.jumped = True
        cp.jumps_total += 1
        self._journal_credit("spend-jump", fid=fid)

    def spend_shield(self, tenant: str) -> None:
        """Spend the tenant's credits to shield its revocable grants from
        the preemption pass for ``shield_epochs`` allocation epochs."""
        cp = self._require_tenancy()
        cp.spend(tenant, cp.cfg.shield_cost)
        cp.shield_until[tenant] = self.epoch_counter + cp.cfg.shield_epochs
        cp.shields_total += 1
        self._journal_credit("spend-shield", tenant=tenant)

    def _journal_credit(self, op: str, **extra) -> None:
        """Journal a credit-ledger mutation with ABSOLUTE post-op maps —
        replay restores the maps verbatim, order-independent."""
        if self.journal is None:
            return
        rec = {"t": _journal.CREDIT, "op": op}
        rec.update(self.tenancy.credit_state())
        rec.update(extra)
        self.journal.append(rec)

    def _tenant_shares(self) -> dict:
        """tenant -> aggregate UNWEIGHTED dominant share of its registered
        frameworks' holdings over pooled capacity (the floor/credit and
        admission-ordering currency; phi stays an intra-allocation weight)."""
        ctot, _level = self._fair_consts()
        cp = self.tenancy
        agg: dict = {}
        for fid, fw in self.frameworks.items():
            t = fid if cp is None else cp.tenant_of.get(fid, fid)
            cur = agg.get(t)
            agg[t] = fw.usage if cur is None else cur + fw.usage
        if ctot is None:
            return {t: 0.0 for t in agg}
        denom = np.maximum(ctot[0], 1e-30)
        return {t: float(np.max(u / denom)) for t, u in agg.items()}

    def _admission_gate(self) -> None:
        """Drain the admission queue (bounded by the per-epoch budget) in
        demand-aware order, registering each admitted entry.  Runs BEFORE
        the epoch tick, the preemption pass and the journal bracket, so
        the records land outside the bracket (replayed eagerly) and the
        admitted frameworks participate in this very epoch."""
        cp = self.tenancy
        if cp.last_gate_epoch > self.epoch_counter:
            # this epoch's admissions were already applied — a recovery
            # replayed the admit record (it lands OUTSIDE the epoch
            # bracket) and is now re-running the dangling epoch itself
            return
        if not cp.queue:
            return
        ctot, _level = self._fair_consts()
        order = cp.admission_order(self._tenant_shares(),
                                   None if ctot is None else ctot[0])
        budget = cp.cfg.max_admissions_per_epoch
        if budget is not None:
            order = order[:budget]
        admitted = []
        for entry in order:
            cp.dequeue(entry.fid)
            # suppress the separate fw-register record: the batch ADMIT
            # record below subsumes registration (its replay re-registers
            # from the queued entries), so journaling both would tear
            jn, self.journal = self.journal, None
            try:
                self.register(entry.fid, demand=entry.demand,
                              wanted_tasks=entry.wanted, phi=entry.phi,
                              allowed_agents=entry.allowed)
            finally:
                self.journal = jn
            cp.tenant_of[entry.fid] = entry.tenant
            admitted.append(entry.fid)
            self.last_admissions.append(
                (entry.fid, entry.tenant, entry.t_enqueue))
        if admitted:
            # one atomic record for the whole gate run — a journal cut
            # either sees every admission of this epoch or none, and the
            # epoch watermark makes replay-then-re-run idempotent
            cp.last_gate_epoch = self.epoch_counter + 1
            self._journal_rec({"t": _journal.ADMIT, "fids": admitted,
                               "epoch": cp.last_gate_epoch})

    def _accrue_credits(self) -> None:
        """Per-epoch credit accrual: every tenant whose aggregate share
        sits under the equal split across active tenants earns
        ``credit_accrual`` credits.  One journal record per epoch with
        absolute balances (skipped when nothing accrued)."""
        cp = self.tenancy
        rate = cp.cfg.credit_accrual
        if rate <= 0.0:
            return
        if cp.last_accrued_epoch >= self.epoch_counter:
            # this epoch's accrual was already applied — a recovery
            # replayed the accrue record (it lands OUTSIDE the epoch
            # bracket) and is now re-running the epoch itself
            return
        shares = self._tenant_shares()
        if not shares:
            return
        split = 1.0 / len(shares)
        changed = False
        for t in sorted(shares):
            if shares[t] < split - cp.cfg.eps:
                cp.accrue(t, rate)
                changed = True
        if changed:
            cp.last_accrued_epoch = self.epoch_counter
            self._journal_credit("accrue")

    def _epoch_open(self) -> None:
        """Shared prologue of EVERY allocation-epoch path (per-grant,
        batched host, fused device, async begin): drain the admission
        queue, tick the epoch counter (only for epochs with work — the
        same condition that opens a journal bracket, so replay restores
        the counter from epoch-begin records exactly), accrue credits.
        Everything here precedes the preemption pass and the view freeze."""
        if self.tenancy is not None:
            self._admission_gate()
        if self.frameworks and self.state.n_agents > 0:
            self.epoch_counter += 1
            if self.tenancy is not None:
                self._accrue_credits()

    # -- scoring ------------------------------------------------------------

    def _sync_demand(self, fid: str) -> None:
        """Mirror the (possibly inferred) scoring demand into ClusterState."""
        fw = self.frameworks.get(fid)
        if fw is None or fid not in self.state.fid2slot:
            return
        if fw.demand is None:  # oblivious: inferred demand drifts with usage
            self.state.set_demand(fid, fw.inferred_demand())

    def _framework_scores(self, view):
        """(N, A) scores; oblivious DRF/TSF score on aggregate usage."""
        name = self.crit.name
        if name in ("drf", "tsf"):
            if self.mode == "oblivious":
                usage = np.array([self.frameworks[f].usage for f in view.fids])
                s = criteria.usage_dominant_share(usage, view.C, view.phi)
            else:
                s = self.crit.scores(view.X, view.D, view.C, view.phi,
                                     lookahead=False)
            return np.broadcast_to(s[:, None], (len(s), view.C.shape[0]))
        return self.crit.scores(
            view.X, view.D, view.C, view.phi, lookahead=False
        )  # psdsf / rpsdsf -> (N, A)

    # -- allocation epoch ----------------------------------------------------

    def _preempt_pass(self) -> list:
        """Run the epoch-level preemption pass (no-op when disabled); the
        revocations also land in :attr:`last_revocations`."""
        if (self.preemption is None or not self.frameworks
                or self.state.n_agents == 0):
            self.last_revocations = []
        else:
            self.last_revocations = _preemption.preempt_pass(self)
        return self.last_revocations

    def _fair_consts(self):
        """(ctot (1, R), fair level) for the revocability test — epoch
        invariants (they change only on membership mutations, which bump
        ``ClusterState._version``), cached so the per-grant classification
        stays O(R) instead of re-summing capacities and phis per grant."""
        cache = self._fair_cache
        if cache is None or cache[0] != self.state._version:
            slots = list(self.state.agent2slot.values())
            ctot = (np.sum(self.state.C[slots], axis=0, keepdims=True)
                    if slots else None)
            phis = np.fromiter((f.phi for f in self.frameworks.values()),
                               np.float64, len(self.frameworks))
            level = criteria.fair_share_level(phis) if len(phis) else None
            cache = (self.state._version, ctot, level)
            self._fair_cache = cache
        return cache[1], cache[2]

    def _grant_is_revocable(self, fw, usage_after: np.ndarray) -> bool:
        """Would this grant leave fw OVER threshold * its phi-weighted fair
        share?  (criteria owns the share math — see fair_share_level.)

        With a tenancy control plane attached and a quota floor configured
        for fw's tenant, the membership-relative rule is replaced by the
        absolute floor rule: firm while the TENANT's aggregate unweighted
        dominant share (this grant included) stays at or under the floor,
        revocable above it — even when the tenant is alone on the cluster
        (the lone-tenant gap; see repro.core.tenancy)."""
        ctot, level = self._fair_consts()
        if ctot is None or level is None:
            return False
        cp = self.tenancy
        if cp is not None:
            tenant = cp.tenant_of.get(fw.fid, fw.fid)
            floor = cp.cfg.floor_of(tenant)
            if floor > 0.0:
                agg = usage_after
                for ofid, ofw in self.frameworks.items():
                    if (ofid != fw.fid
                            and cp.tenant_of.get(ofid, ofid) == tenant):
                        agg = agg + ofw.usage
                share = float(np.max(agg / np.maximum(ctot[0], 1e-30)))
                return bool(share > floor + self.preemption.eps)
        share = criteria.usage_dominant_share(
            usage_after[None, :], ctot, np.asarray([fw.phi]))[0]
        return bool(share > self.preemption.threshold * level
                    + self.preemption.eps)

    def allocate(self, per_agent_limit: Optional[int] = None,
                 batched: bool = False, use_kernel="auto") -> list[Grant]:
        """Run one allocation epoch; returns grants.

        per_agent_limit models Mesos's offer cycle: each agent's resources are
        offered at most that many times per cycle (1 = one offer per agent per
        cycle, the Mesos default behaviour). None = fill to saturation (the
        progressive-filling idealization of Section 2).

        batched=True uses the incremental :class:`BatchedEpoch` engine with
        the shared server-policy objects (reference-filler semantics for RRR
        rounds); batched=False keeps the legacy per-grant offer semantics.
        use_kernel picks the batched backend (default ``"auto"``: numpy below
        the measured device crossover, the fused device epoch above it — see
        :meth:`allocate_batched`).
        """
        if batched:
            return self.allocate_batched(per_agent_limit,
                                         use_kernel=use_kernel)
        self._epoch_open()     # admissions + epoch tick + credit accrual
        self._preempt_pass()   # epoch-level pass precedes the grant loop
        # per-grant epochs are journal-bracketed too: even a zero-grant RRR
        # epoch draws permutations, so recovery needs the commit record's
        # rng fast-forward (skipped only when the epoch cannot draw at all).
        jrnl = (self.journal is not None and bool(self.frameworks)
                and self.state.n_agents > 0)
        if jrnl:
            self._journal_begin("pergrant-loop", per_agent_limit,
                                self.rng.bit_generator.state)
        grants: list[Grant] = []
        used: dict[str, int] = {}
        guard = 0
        while True:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("allocation epoch did not converge")
            blocked = (
                {a for a, k in used.items() if k >= per_agent_limit}
                if per_agent_limit is not None else set()
            )
            g = self._allocate_one(blocked)
            if g is None:
                if jrnl:
                    self._journal_commit(grants)
                if self.audit:
                    _invariants.assert_invariants(self)
                return grants
            used[g.agent] = used.get(g.agent, 0) + 1
            grants.append(g)

    def allocate_batched(self, per_agent_limit: Optional[int] = None,
                         tie: str = "low", use_kernel="auto",
                         shards: int = 1, devices: int = 1) -> list[Grant]:
        """Batched epoch: score once, grant many (see module docstring).

        ``use_kernel`` selects the backend:

          * ``"auto"`` (default) — pick numpy vs the fused device epoch from
            (N, J, jax backend) against the crossover measured in
            ``benchmarks/allocator_bench.py``
            (:data:`repro.core.engine.AUTO_KERNEL_MIN_CELLS`); below the
            floor the resolver never imports jax, and RRR always stays on
            the host path (the fused RRR rng pre-draw would make seeded
            cross-epoch sequences backend/size-dependent).  Never slower
            than the old numpy default at the benched sizes (asserted in
            the bench ``--quick`` smoke).
          * ``True`` / ``"fused"`` — the device-resident epoch engine
            (:mod:`repro.core.engine_jax`): the whole select -> grant ->
            refresh loop runs as ONE jitted ``lax.while_loop`` dispatch.
            Covers characterized mode, ``tie="low"``, every criterion under
            the pooled/rrr policies (phi, constraints, per_agent_limit
            included); anything else silently falls back to the numpy
            incremental path.  Fused RRR pre-draws its server permutations
            from the allocator rng (see the engine_jax module docstring for
            the cross-epoch rng-stream caveat).
          * ``"pergrant"`` — the legacy per-grant ``psdsf_argmin``
            backend (the CUDA kernel K4 on the card, its plain version on
            the CPU; one kernel launch + readback per pick; characterized
            rPS-DSF + pooled only), kept for benchmarking the boundary cost.
          * ``False`` — pure numpy incremental epoch.

        ``shards > 1`` partitions the fused epoch's in-loop selects across
        agent shards; ``devices > 1`` shards the epoch state itself over a
        device mesh (``engine_jax.epoch_loop_mesh`` — each device keeps its
        agent-block resident, only reduce partials cross the interconnect).
        Both are parity-gated (see the engine_jax module docstring), and
        under ``"auto"`` both collapse to the plain fused dispatch below
        their measured floors (:meth:`_resolve_partition`).

        Implemented as ``commit_epoch(begin_epoch(...))`` — the synchronous
        path and the asynchronous pipeline are the same code.
        """
        return self.commit_epoch(self.begin_epoch(
            per_agent_limit, tie=tie, use_kernel=use_kernel, shards=shards,
            devices=devices))

    # -- the asynchronous epoch pipeline -------------------------------------

    def _resolve_kernel(self, use_kernel, N: int, J: int, tie: str):
        """Resolve a ``use_kernel`` spec to ``False | "pergrant" | "fused"``."""
        if use_kernel in (False, None):
            return False
        if use_kernel == "pergrant":
            return "pergrant"
        if use_kernel in (True, "fused"):
            from repro_torch.core import engine_torch

            return "fused" if engine_torch.supports(
                self.crit, self.server_policy, self.mode, tie) else False
        if use_kernel == "auto":
            if N * J < AUTO_KERNEL_FLOOR_CELLS:
                return False        # small epoch: never pay the jax import
            if self.server_policy == "rrr":
                # the fused RRR path pre-draws a whole permutation budget
                # from the shared rng, so ACROSS epochs its stream position
                # differs from the numpy policy's — auto must never make a
                # seeded run's grant sequences depend on backend or cluster
                # size.  Fused RRR stays an explicit opt-in.
                return False
            if not self.device_health.allow_auto_device():
                # quarantined device path (K consecutive fused failures):
                # auto degrades to the host engine until a probe epoch —
                # every probe_every-th auto resolution — succeeds.
                return False
            from repro_torch.core import engine_torch

            if not engine_torch.supports(self.crit, self.server_policy,
                                         self.mode, tie):
                return False
            min_cells = AUTO_KERNEL_MIN_CELLS[self.device.type]
            return "fused" if N * J >= min_cells else False
        raise ValueError(f"unknown use_kernel spec {use_kernel!r}")

    # -- the precomputed-epoch cache (repro.core.epoch_cache) ----------------

    def _cacheable(self, kernel, tie: str) -> bool:
        """May this epoch serve from / populate the epoch cache?

        Characterized mode only (oblivious epochs read live framework
        state — inferred-demand drift — OUTSIDE the frozen view, so the
        fingerprint cannot cover them), deterministic ``tie="low"`` only,
        and RRR only on the fused path: the host RRR policy draws its
        permutations lazily, one round at a time, so its rng consumption
        depends on the outcome and cannot be pre-drawn into the key the
        way the fused dispatch-time prefix can."""
        if self.epoch_cache is None or self.mode != "characterized":
            return False
        if tie != "low":
            return False
        if self.server_policy == "rrr" and kernel != "fused":
            return False
        return True

    def _draw_perm_rows(self, k: int, J: int) -> np.ndarray:
        """k RRR permutation rows from the allocator rng — the same draws,
        in the same order, ``engine_jax.run_epoch_async`` would make."""
        rows = np.empty((k, J), np.int64)
        for i in range(k):
            rows[i] = self.rng.permutation(J)
        return rows

    def _cache_fingerprint(self, view, TD, *, kernel, tie, per_agent_limit):
        """(key, preperms, perm_rows0) for this epoch's frozen inputs.

        For fused RRR the permutation prefix is drawn HERE — before lookup,
        from the same stream position a fresh dispatch would draw it — and
        hashed into the key, so equal profiles under different rng streams
        can never share an entry and stream consumption is identical with
        the cache on or off."""
        engine = {"fused": "fused", "pergrant": "host-pergrant",
                  False: "host"}[kernel]
        preperms, nperm0 = None, 0
        if kernel == "fused" and self.server_policy == "rrr":
            from repro_torch.core import engine_torch

            J = len(view.agents)
            bound = engine_torch.grant_bound(
                TD, view.FREE, view.X.sum(axis=1), view.wanted,
                per_agent_limit)
            if bound > 0:     # empty epochs draw nothing (dispatch parity)
                nperm0 = engine_torch.rrr_perm_budget(bound, J)
                preperms = self._draw_perm_rows(nperm0, J)
        pre = self.preemption
        key = _epoch_cache.EpochCache.fingerprint(
            view, TD, criterion=self.criterion, policy=self.server_policy,
            mode=self.mode, tie=tie, engine=engine,
            per_agent_limit=per_agent_limit, bf_metric=self.bf_metric,
            preemption=None if pre is None else (pre.threshold, pre.eps),
            perms=preperms)
        return key, preperms, nperm0

    def _cache_burn_verify(self, key, outcome, J: int):
        """Replay an RRR hit's grow-and-replay draws against the stored
        digest.  Burns ``extra_perm_rows`` permutations so the rng stream
        lands exactly where a fresh dispatch would leave it; a digest
        mismatch (different stream behind a colliding prefix) rewinds the
        stream and demotes the hit to a miss."""
        if outcome.extra_perm_rows <= 0:
            return outcome
        state0 = self.rng.bit_generator.state
        rows = self._draw_perm_rows(outcome.extra_perm_rows, J)
        if _epoch_cache.perm_digest(rows) != outcome.extra_perm_digest:
            self.rng.bit_generator.state = state0
            self.epoch_cache.unhit(key)
            return None
        return outcome

    def _cache_store_fused(self, epoch: InFlightEpoch, seq) -> None:
        """Populate the cache at a device-epoch commit (miss path): the
        sequence (digested, so hit-time integrity verification can detect
        a corrupted entry) plus, for RRR, the permutation rows the run
        drew PAST the fingerprinted prefix (with their digest, for
        hit-time burn)."""
        extra, digest = 0, b""
        perms = epoch.handle.perms
        if self.server_policy == "rrr" and perms is not None:
            extra = perms.shape[0] - epoch.perm_rows0
            if extra > 0:
                J = len(epoch.view.agents)
                digest = _epoch_cache.perm_digest(
                    perms[epoch.perm_rows0:, :J])
        seq = tuple(seq)
        self.epoch_cache.store(
            epoch.cache_key,
            _epoch_cache.EpochOutcome(seq, extra, digest,
                                      _epoch_cache.seq_digest_of(seq)))

    def _apply_seq(self, view, TD, seq) -> list[Grant]:
        """Apply a raw (n, j) grant sequence — a device readback or a cache
        replay — against the LIVE state: re-validate each grant in f64 (the
        device loop tracks FREE in f32, exact for quantized demands but
        driftable for non-dyadic ones — never let a drifted grant drive
        free capacity negative) and funnel it through :meth:`_grant`, so
        revocable-offer classification always runs live."""
        grants: list[Grant] = []
        for n, j in seq:
            slot = self.state.agent2slot[view.agents[j]]
            if (TD[n] > self.state.FREE[slot] + 1e-9).any():
                break
            grants.append(self._grant(view.fids[n], view.agents[j]))
        return grants

    def _resolve_partition(self, use_kernel, N: int, J: int, shards: int,
                           devices: int):
        """Clamp a requested fused-epoch partitioning under ``"auto"``.

        Sharded selects and device-mesh epochs each pay a fixed per-grant
        toll that only amortizes near fleet scale, so the auto rule honors
        ``shards``/``devices`` requests only at or above their measured
        floors (:data:`repro.core.engine.AUTO_SHARD_MIN_CELLS` /
        :data:`~repro.core.engine.AUTO_MESH_MIN_CELLS`) and collapses them
        to the plain fused dispatch below.  Explicit ``use_kernel`` specs
        are a stated choice and pass through untouched — EXCEPT while the
        device path is quarantined (see :class:`~repro.core.faults
        .DeviceHealth`): a failing device mesh degrades to a single device
        on every path until a probe epoch succeeds (health trumps sizing).
        """
        if self.device_health.quarantined and devices > 1:
            devices = 1
        if use_kernel != "auto":
            return shards, devices
        cells = N * J
        if shards > 1 and cells < AUTO_SHARD_MIN_CELLS:
            shards = 1
        if devices > 1 and cells < AUTO_MESH_MIN_CELLS:
            devices = 1
        return shards, devices

    def begin_epoch(self, per_agent_limit: Optional[int] = None,
                    tie: str = "low", use_kernel="auto",
                    shards: int = 1, devices: int = 1) -> InFlightEpoch:
        """Stage one epoch and dispatch it without blocking on the result.

        Freezes the epoch inputs (X/D/C/FREE/phi/allowed/wanted + the true
        demands) into an immutable :meth:`ClusterState.epoch_view` snapshot
        — the upload half of the double buffer — and, when the
        configuration is served by the fused device engine, dispatches the
        epoch asynchronously (``engine_jax.run_epoch_async``).  All
        allocator-rng consumption (the fused RRR permutation pre-draw)
        happens HERE, so begin/commit pairs consume the stream exactly like
        the synchronous path.  Configurations outside device coverage run
        the host engine eagerly at begin time (no overlap, same contract).

        The caller must :meth:`commit_epoch` before mutating the allocator
        again; the live state may serve reads while the epoch is in flight.
        At most ONE epoch may be in flight per allocator — overlapping
        begins would interleave rng consumption (an RRR replay top-up of
        epoch k draws after epoch k+1's pre-draw) and break the sequence
        contract, so they are refused here.
        """
        if self._inflight_epoch is not None:
            raise RuntimeError("an allocation epoch is already in flight; "
                               "commit_epoch() it before beginning another")
        # admission gate + epoch tick + credit accrual, then the preemption
        # pass — both mutate (register / revoke) BEFORE the view freeze, so
        # the dispatched epoch scores the post-admission post-revocation
        # state and the staleness guard below is armed after them.
        self._epoch_open()
        revs = self._preempt_pass()
        # the recovery anchor: every draw this epoch makes (RRR preperm
        # prefix, host per-round permutations, grow-and-replay top-ups)
        # happens past this point, so abort_epoch()/self-healing can rewind
        # the stream to exactly the pre-epoch position.  Captured AFTER the
        # preemption pass (rng-free, but its revocations are live mutations
        # that stand regardless — same as on the synchronous path).
        rng_state0 = self.rng.bit_generator.state
        if not self.frameworks or self.state.n_agents == 0:
            return InFlightEpoch(view=None, TD=None,
                                 per_agent_limit=per_agent_limit, grants=[],
                                 guard=self.state.mutation_count,
                                 revocations=revs)
        view = self.state.epoch_view()
        N = len(view.fids)
        TD = np.zeros((N, self.R))
        for i, f in enumerate(view.fids):
            fw = self.frameworks[f]
            if fw.n_tasks < fw.wanted_tasks:
                TD[i] = self._true_demand(f)
        TD.setflags(write=False)
        kernel = self._resolve_kernel(use_kernel, N, len(view.agents), tie)
        # bracket opens at kernel resolution: every rng draw (fused preperm
        # prefix, host per-round permutations) lands inside it, and a crash
        # before the matching commit/abort record recovers by rewinding to
        # rng_state0 (the deterministic-abort rule).
        self._journal_begin(
            {"fused": "fused", "pergrant": "host-pergrant",
             False: "host"}[kernel],
            per_agent_limit, rng_state0, view=view, TD=TD, tie=tie)

        # precomputed-epoch lookup BEFORE any dispatch: a hit skips the
        # engine entirely and replays the recorded sequence — deferred to
        # commit on the fused path (parity with a device readback: guard
        # armed, revocations refused in between), applied eagerly here on
        # host paths (parity with the host fallback, which also applies at
        # begin).  A miss remembers the key and dispatches exactly as
        # without a cache.
        key = preperms = None
        nperm0 = 0
        if self._cacheable(kernel, tie):
            key, preperms, nperm0 = self._cache_fingerprint(
                view, TD, kernel=kernel, tie=tie,
                per_agent_limit=per_agent_limit)
            out = self.epoch_cache.lookup(key)
            if out is not None and not _epoch_cache.verify_seq(out):
                # hit integrity: a corrupted entry (grant-sequence digest
                # mismatch) is evicted and the epoch falls through to a
                # fresh dispatch instead of committing garbage.
                self.epoch_cache.evict_corrupt(key)
                self.fault_stats.cache_corruptions_evicted += 1
                self._notify_fault("cache-corrupt-evict")
                out = None
            if out is not None:
                out = self._cache_burn_verify(key, out, len(view.agents))
            if out is not None:
                if kernel == "fused":
                    epoch = InFlightEpoch(view=view, TD=TD,
                                          per_agent_limit=per_agent_limit,
                                          cached_seq=out.seq,
                                          guard=self.state.mutation_count,
                                          revocations=revs,
                                          rng_state0=rng_state0, tie=tie)
                    self._inflight_epoch = epoch
                    return epoch
                grants = self._apply_seq(view, TD, out.seq)
                self._journal_commit(grants)
                if self.audit:
                    _invariants.assert_invariants(self)
                return InFlightEpoch(view=view, TD=TD,
                                     per_agent_limit=per_agent_limit,
                                     grants=grants,
                                     guard=self.state.mutation_count,
                                     revocations=revs)

        if kernel == "fused":
            shards, devices = self._resolve_partition(
                use_kernel, N, len(view.agents), shards, devices)
            handle = self._dispatch_fused(view, TD, per_agent_limit,
                                          shards, devices, preperms)
            if handle is not None:
                epoch = InFlightEpoch(view=view, TD=TD,
                                      per_agent_limit=per_agent_limit,
                                      handle=handle,
                                      guard=self.state.mutation_count,
                                      revocations=revs, cache_key=key,
                                      perm_rows0=nperm0,
                                      rng_state0=rng_state0, tie=tie,
                                      shards=shards, devices=devices)
                self._inflight_epoch = epoch
                return epoch
            # device path down (retries exhausted): self-heal on the host
            # engine with the rng rewound to its pre-draw position — for
            # RRR the lazy host draws then replay the identical stream the
            # fused pre-draw consumed, so the grant sequence is
            # bit-identical to the no-fault fused run (engine parity).
            self.rng.bit_generator.state = rng_state0
            kernel = False
            key = None   # host-run grants must not populate the fused key
        grants, seq = self._allocate_batched_host(per_agent_limit, tie,
                                                  kernel, view, TD)
        if key is not None:   # host miss: applied already, store eagerly
            seq = tuple(seq)
            self.epoch_cache.store(key, _epoch_cache.EpochOutcome(
                seq, seq_digest=_epoch_cache.seq_digest_of(seq)))
        self._journal_commit(grants)
        if self.audit:
            _invariants.assert_invariants(self)
        return InFlightEpoch(view=view, TD=TD,
                             per_agent_limit=per_agent_limit, grants=grants,
                             guard=self.state.mutation_count,
                             revocations=revs)

    def commit_epoch(self, epoch: InFlightEpoch) -> list[Grant]:
        """Commit an in-flight epoch: block on the device grant sequence,
        re-validate each grant in f64 against the LIVE state and apply it
        incrementally.  Bit-for-bit identical to the synchronous path (which
        is begin+commit back to back).  Raises if the cluster state was
        mutated since :meth:`begin_epoch` — the commit point is the caller's
        contract, not something this method can reorder around.  (The
        staleness guard protects DEFERRED application, so it applies to
        device epochs only: a host-fallback epoch already applied its
        grants at begin time, making later mutations as legal as they are
        after any synchronous epoch.)"""
        if epoch.consumed:
            raise RuntimeError("epoch handle already committed")
        epoch.consumed = True
        if self._inflight_epoch is epoch:
            self._inflight_epoch = None
        if epoch.grants is not None:   # host fallback: applied at begin time
            return epoch.grants
        if self.state.mutation_count != epoch.guard:
            # refusal path: the epoch's rng draws (RRR preperm prefix) must
            # not leak into the stream — rewind so the caller can re-begin
            # from a clean position instead of a wedged one.
            if epoch.rng_state0 is not None:
                self.rng.bit_generator.state = epoch.rng_state0
            self.fault_stats.commit_refusals += 1
            self._notify_fault("commit-refused")
            self._journal_abort()
            raise RuntimeError(
                "cluster state mutated while an allocation epoch was in "
                "flight; commit_epoch() must run before any other allocator "
                "mutation")
        if self.audit:
            _invariants.check_view_agreement(self, epoch.view)
        if epoch.cached_seq is not None:   # epoch-cache hit: replay
            grants = self._apply_seq(epoch.view, epoch.TD, epoch.cached_seq)
        else:
            grants = self._commit_fused(epoch)
        self._journal_commit(grants)
        if self.audit:
            _invariants.assert_invariants(self)
        return grants

    # -- self-healing dispatch (core.faults) ---------------------------------

    def _dispatch_fused(self, view, TD, per_agent_limit, shards, devices,
                        preperms):
        """Dispatch the fused device epoch, retrying transient failures with
        capped exponential backoff (:class:`~repro.core.faults
        .RecoveryPolicy`).  Returns the :class:`EpochHandle`, or ``None``
        after retries are exhausted — the caller then self-heals on the
        host engine.  Each attempt restores the rng to its own pre-attempt
        position so a failed dispatch consumes no stream.  A
        :class:`~repro_torch.kernels.KernelError` (a kernel that does not
        build, launch or run) is raised, here and at commit: it is never
        transient, and finishing on the host would hide it."""
        from repro_torch.core import engine_torch

        pol = self.recovery
        inj = self.fault_injector
        for attempt in range(pol.max_retries + 1):
            if attempt:
                self.fault_stats.retries += 1
                if pol.backoff_s > 0:
                    _time.sleep(pol.backoff(attempt - 1))
            state = self.rng.bit_generator.state
            try:
                if inj is not None and inj.take_dispatch_fault():
                    raise inj.error("dispatch")
                handle = engine_torch.run_epoch_async(
                    self.crit, self.server_policy,
                    X=view.X, D=view.D, C=view.C, FREE=view.FREE,
                    phi=view.phi, allowed=view.allowed, wanted=view.wanted,
                    true_demands=TD, per_agent_limit=per_agent_limit,
                    lookahead=False, rng=self.rng, shards=shards,
                    devices=devices, preperms=preperms, device=self.device,
                )
            except KernelError:      # a broken kernel is never transient
                self.rng.bit_generator.state = state
                raise
            except Exception as exc:
                self.rng.bit_generator.state = state
                self.fault_stats.dispatch_failures += 1
                self._notify_fault("dispatch-error", error=repr(exc),
                                   attempt=attempt)
                continue
            if attempt:
                self.fault_stats.retry_successes += 1
                self._notify_fault("retry-success", where="dispatch")
            return handle
        if self.device_health.on_failure():
            self._notify_fault("quarantine",
                               **self.device_health.counters())
        self.fault_stats.host_fallbacks += 1
        self._notify_fault("host-fallback", where="dispatch")
        return None

    def _commit_fused(self, epoch: InFlightEpoch) -> list[Grant]:
        """Block on the device result and apply it; a failure (XLA error,
        injected fault, timeout) enters :meth:`_recover_commit`."""
        inj = self.fault_injector
        try:
            if inj is not None and inj.take_commit_fault():
                raise inj.error("commit")
            seq = epoch.handle.result()
        except KernelError:
            raise
        except Exception as exc:
            return self._recover_commit(epoch, exc)
        if self.device_health.on_success():
            self._notify_fault("probe-success",
                               **self.device_health.counters())
        if epoch.cache_key is not None and self.epoch_cache is not None:
            self._cache_store_fused(epoch, seq)
        return self._apply_seq(epoch.view, epoch.TD, seq)

    def _redispatch(self, epoch: InFlightEpoch):
        """Re-dispatch a failed fused epoch from its frozen view.  The rng
        was rewound to ``rng_state0`` first, so ``preperms=None`` makes the
        engine re-draw the identical RRR prefix (``rrr_perm_budget`` is a
        pure function of the profile) — the retry is a replay, not a new
        sample."""
        from repro_torch.core import engine_torch

        inj = self.fault_injector
        if inj is not None and inj.take_dispatch_fault():
            raise inj.error("dispatch")
        view = epoch.view
        return engine_torch.run_epoch_async(
            self.crit, self.server_policy,
            X=view.X, D=view.D, C=view.C, FREE=view.FREE,
            phi=view.phi, allowed=view.allowed, wanted=view.wanted,
            true_demands=epoch.TD, per_agent_limit=epoch.per_agent_limit,
            lookahead=False, rng=self.rng, shards=epoch.shards,
            devices=epoch.devices, preperms=None, device=self.device,
        )

    def _recover_commit(self, epoch: InFlightEpoch, exc) -> list[Grant]:
        """Self-heal a failed fused commit.  Retries the device dispatch
        with backoff (rng rewound before each, so every attempt replays the
        same stream); once exhausted, quarantines the device path and
        re-runs the HOST engine over the same frozen view — which, after
        the rewind, draws the identical permutation stream and produces the
        bit-identical grant sequence the device would have returned."""
        pol = self.recovery
        self.fault_stats.commit_failures += 1
        self._notify_fault("commit-error", error=repr(exc))
        for attempt in range(pol.max_retries):
            self.fault_stats.retries += 1
            if pol.backoff_s > 0:
                _time.sleep(pol.backoff(attempt))
            if epoch.rng_state0 is not None:
                self.rng.bit_generator.state = epoch.rng_state0
            try:
                handle = self._redispatch(epoch)
                seq = handle.result()
            except KernelError:
                raise
            except Exception as exc2:
                self.fault_stats.dispatch_failures += 1
                self._notify_fault("dispatch-error", error=repr(exc2),
                                   attempt=attempt + 1)
                continue
            epoch.handle = handle   # perms for _cache_store_fused
            self.fault_stats.retry_successes += 1
            self._notify_fault("retry-success", where="commit")
            if self.device_health.on_success():
                self._notify_fault("probe-success",
                                   **self.device_health.counters())
            if epoch.cache_key is not None and self.epoch_cache is not None:
                self._cache_store_fused(epoch, seq)
            return self._apply_seq(epoch.view, epoch.TD, seq)
        if self.device_health.on_failure():
            self._notify_fault("quarantine",
                               **self.device_health.counters())
        if epoch.rng_state0 is not None:
            self.rng.bit_generator.state = epoch.rng_state0
        self.fault_stats.host_fallbacks += 1
        self._notify_fault("host-fallback", where="commit")
        grants, _seq = self._allocate_batched_host(
            epoch.per_agent_limit, epoch.tie, False, epoch.view, epoch.TD)
        return grants   # host-run grants never populate the fused cache key

    def abort_epoch(self, epoch: Optional[InFlightEpoch] = None) -> bool:
        """Abandon an in-flight epoch without applying its grants.

        Rewinds the allocator rng to its pre-epoch position (so the next
        ``begin_epoch`` draws the stream the aborted one consumed) and
        clears the in-flight slot; the epoch cache is untouched.  Returns
        True if an epoch was aborted, False if there was nothing to abort.
        Host epochs (grants applied eagerly at begin time) cannot be
        aborted — their effects are already live."""
        if epoch is None:
            epoch = self._inflight_epoch
        if epoch is None or epoch.consumed:
            return False
        if epoch.grants is not None:
            raise RuntimeError("cannot abort a host epoch: its grants were "
                               "applied at begin time")
        epoch.consumed = True
        if self._inflight_epoch is epoch:
            self._inflight_epoch = None
        if epoch.rng_state0 is not None:
            self.rng.bit_generator.state = epoch.rng_state0
        self.fault_stats.epoch_aborts += 1
        self._notify_fault("epoch-abort")
        self._journal_abort()
        return True

    def _allocate_batched_host(self, per_agent_limit, tie, kernel,
                               view, TD):
        """The numpy incremental epoch (optionally the per-grant K4
        backend) over a frozen view — the host half of the epoch pipeline.
        Returns ``(grants, seq)``: the applied grants plus the raw (n, j)
        pick sequence (what the epoch cache stores)."""
        usage = None
        if self.mode == "oblivious":
            usage = np.array([self.frameworks[f].usage for f in view.fids])
        epoch = BatchedEpoch(
            self.crit, self.server_policy,
            X=view.X, D=view.D, C=view.C, FREE=view.FREE, phi=view.phi,
            allowed=view.allowed, wanted=view.wanted, true_demands=TD,
            mode=self.mode, lookahead=False, tie=tie, rng=self.rng,
            bf_metric=self.bf_metric, per_agent_limit=per_agent_limit,
            usage=usage, use_kernel=(kernel == "pergrant"),
            device=self.device,
        )
        grants: list[Grant] = []
        seq: list[tuple[int, int]] = []
        passes_d = self.crit.server_specific and self.mode == "oblivious"
        for _ in range(100_000):
            pick = epoch.select()
            if pick is None:
                return grants, seq
            n, j = pick
            seq.append((n, j))
            fid = view.fids[n]
            g = self._grant(fid, view.agents[j])
            grants.append(g)
            fw = self.frameworks[fid]
            epoch.apply(
                n, j, g.bundle, g.n_executors,
                new_demand_row=(fw.inferred_demand() if passes_d else None),
                new_usage_row=(fw.usage if usage is not None else None),
            )
        raise RuntimeError("allocation epoch did not converge")

    # the paper's executor demands are known to the *framework* even in
    # oblivious mode (Spark needs them to size executors); the allocator
    # learns them only through accepted offers.
    framework_demand_oracle: Optional[Callable[[str], np.ndarray]] = None

    def _true_demand(self, fid: str) -> np.ndarray:
        fw = self.frameworks[fid]
        if fw.demand is not None:
            return fw.demand
        if self.framework_demand_oracle is None:
            raise RuntimeError("oblivious mode needs framework_demand_oracle")
        return np.asarray(self.framework_demand_oracle(fid), np.float64)

    def _wants(self, fid: str) -> bool:
        fw = self.frameworks[fid]
        return fw.n_tasks < fw.wanted_tasks

    def _feasible_mask(self, view, blocked=()):
        """(N, A) one-more-executor feasibility using true demands."""
        fids, ags = view.fids, view.agents
        feas = np.zeros((len(fids), len(ags)), bool)
        ok = np.array([a not in blocked for a in ags])
        for i, f in enumerate(fids):
            if not self._wants(f):
                continue
            d = self._true_demand(f)
            feas[i] = (
                (d[None, :] <= view.FREE + 1e-9).all(axis=1) & ok
                & view.allowed[i]
            )
        return feas

    def _allocate_one(self, blocked=()) -> Optional[Grant]:
        if not self.frameworks or self.state.n_agents == 0:
            return None
        view = self.state.sorted_view()
        fids, ags = view.fids, view.agents
        feas = self._feasible_mask(view, blocked)
        if not feas.any():
            return None
        scores = self._framework_scores(view)

        if self.server_policy == "pooled" and self.crit.server_specific:
            s = np.where(feas, scores, np.inf)
            n, a = np.unravel_index(np.argmin(s), s.shape)
        elif self.server_policy == "bestfit":
            per_fw = np.where(feas, scores, np.inf).min(axis=1)
            n = int(np.argmin(per_fw))
            bf = criteria.bestfit_scores(view.FREE, self._true_demand(fids[n]),
                                         metric=self.bf_metric)
            a = int(np.argmin(np.where(feas[n], bf, np.inf)))
        else:  # rrr (and pooled with a global criterion — legacy behaviour)
            order = self.rng.permutation(len(ags))
            a = next((j for j in order if feas[:, j].any()), None)
            if a is None:
                return None
            n = int(np.argmin(np.where(feas[:, a], scores[:, a], np.inf)))
        fid, agent = fids[n], ags[a]
        return self._grant(fid, agent)

    def _grant(self, fid: str, agent: str) -> Grant:
        fw = self.frameworks[fid]
        d = self._true_demand(fid)
        j = self.state.agent2slot[agent]
        if self.mode == "characterized":
            n_exec = 1
            bundle = d.copy()
        else:
            # Coarse offer (paper §3.5.3): the framework is offered the
            # agent's ENTIRE free vector and accepts all of it, carving out
            # as many executors as fit; the remainder is HELD as slack until
            # the framework deregisters ("leaving nothing available for
            # others") — this is the oblivious-mode waste mechanism.
            offer = self.state.FREE[j].copy()
            fit = int(np.floor((offer / np.maximum(d, 1e-30)).min()))
            n_exec = max(1, min(fit, fw.wanted_tasks - fw.n_tasks))
            bundle = offer
            fw.slack[agent] = fw.slack.get(agent, np.zeros(self.R)) + (offer - d * n_exec)
        # revocable-offer classification (preemption enabled only): a grant
        # that pushes fw OVER threshold * its phi-weighted fair share is
        # revocable; every grant under it is firm.  All grant paths
        # (per-grant, batched host, device commit) funnel through here, so
        # classification parity across engines is free.
        revocable = (self.preemption is not None
                     and self._grant_is_revocable(fw, fw.usage + bundle))
        if revocable:
            fw.revocable[agent] = fw.revocable.get(agent, 0) + n_exec
        if self.preemption is not None:
            # hysteresis freshness stamp: the pair's newest grant epoch
            # (revocation pops LIFO, so pair-level freshness IS per-grant
            # freshness — see PreemptionPolicy.hysteresis_epochs).
            self._grant_epoch[(fid, agent)] = self.epoch_counter
        self.state.grant(fid, agent, bundle, n_exec,
                         revocable_units=n_exec if revocable else 0)
        fw.tasks.setdefault(agent, []).extend([d.copy()] * n_exec)
        fw.usage = fw.usage + bundle
        fw.grants += 1
        self._sync_demand(fid)
        # every grant path funnels through here, so one journal hook covers
        # per-grant, batched-host, device-commit and cache-replay grants;
        # recovery replays the records through this same method.
        self._journal_rec({"t": _journal.GRANT, "fid": fid, "agent": agent})
        return Grant(fid=fid, agent=agent, bundle=bundle, n_executors=n_exec,
                     revocable=revocable)

    # -- metrics -------------------------------------------------------------

    def snapshot(self) -> AllocSnapshot:
        """Telemetry snapshot for metrics hooks (O(N*R), no dict rebuilds)."""
        slots = list(self.state.agent2slot.values())
        cap = free = None
        if slots:
            cap = np.sum(self.state.C[slots], axis=0)
            free = np.sum(self.state.FREE[slots], axis=0)
        n = len(self.frameworks)
        usage = (np.array([fw.usage for fw in self.frameworks.values()])
                 if n else np.zeros((0, self.R)))
        phi = np.fromiter((fw.phi for fw in self.frameworks.values()),
                          np.float64, n)
        return AllocSnapshot(fids=tuple(self.frameworks), usage=usage,
                             phi=phi, cap_total=cap, free_total=free)

    def utilization(self) -> np.ndarray:
        """(R,) fraction of total capacity currently allocated."""
        cap = np.sum(list(self.agents.values()), axis=0)
        free = np.sum(list(self.free.values()), axis=0)
        return (cap - free) / np.maximum(cap, 1e-30)
