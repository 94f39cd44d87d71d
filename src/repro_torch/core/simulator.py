"""Discrete-event simulator of Spark workloads on a Mesos-style cluster.

Models the paper's Section 3 experiments:
  * each job (= Mesos framework) is divided into microtasks; executors are
    Mesos tasks that *pull* microtasks from the driver (one at a time);
  * stragglers: a small fraction of tasks run ~10x long; with speculative
    execution the driver relaunches slow tasks near the job barrier and takes
    the first finisher (paper §3.2);
  * executors live until the job completes, then all resources are released
    and the allocator runs a new epoch (churn);
  * agents may register late (paper §3.7) or fail mid-run (fault injection).

Ownership split: the simulator owns **event ordering only**.  What arrives
when is a :class:`repro.core.workloads.WorkloadSource` (the paper's two-group
queue mixes, bursty/heavy-tailed generators, gang-job streams, trace replay);
what is measured is a set of :class:`repro.core.metrics.SimHook` objects fed
allocator snapshots at every state change (the legacy ``SimResult.timeline``
is itself produced by a built-in
:class:`~repro.core.metrics.UtilizationTimelineHook`).

The allocator is :class:`repro.core.online.OnlineAllocator`, so every
(criterion x server-policy x mode) combination from the paper is runnable;
``SimConfig.batched=True`` routes epochs through the incremental
:class:`~repro.core.engine.BatchedEpoch` engine
(:func:`assert_batched_parity` pins it against the legacy per-grant path),
with ``use_kernel`` choosing the epoch backend (default ``"auto"``).

Asynchronous epochs (``SimConfig.async_epochs=True``, requires batched):
an allocation event *dispatches* the device epoch
(``OnlineAllocator.begin_epoch``) and returns to the event loop without
blocking on the grant readback.  The COMMIT POINT is deterministic: the
in-flight epoch is committed before the next popped event is processed
(the event is pushed back with its original sequence number and re-popped,
since committing may insert earlier events), while ``now`` still equals
the dispatching epoch's time.  Grant application, hooks, executor dispatch
and telemetry sampling therefore happen at exactly the simulated time —
and in exactly the event order — of the synchronous path, so traces are
bit-for-bit identical (pinned by tests/test_async_pipeline.py against the
golden scenario grid).  Exactness bounds the in-sim overlap window to the
heap turnaround: every DES event either observes grant effects or races
the allocator's pending-cycle bookkeeping, so none may run mid-flight (the
epoch-scale throughput win comes from pipelining epochs of independent
allocators through the same begin/commit protocol — measured in
``benchmarks/allocator_bench.py`` ``device-async`` rows).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import faults as _faults
from repro_torch.core import invariants as _invariants
from repro_torch.core import metrics as _metrics
from repro_torch.core.online import OnlineAllocator
from repro_torch.core.workloads import (  # noqa: F401  (JobSpec re-exported: legacy API)
    Arrival,
    JobSpec,
    SyntheticQueueSource,
    WorkloadSource,
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    criterion: str = "drf"
    server_policy: str = "rrr"
    mode: str = "characterized"          # characterized | oblivious
    bf_metric: str = "cosine"
    jobs_per_queue: int = 10
    n_queues_per_group: int = 5
    straggler_prob: float = 0.05
    straggler_factor: float = 10.0
    speculation: bool = True
    spec_multiplier: float = 1.8
    spec_min_elapsed: float = 4.0
    alloc_interval: float = 1.0          # Mesos periodic allocation cycle
    submit_delay: float = 3.0            # Spark driver startup latency
    release_jitter: float = 2.0          # executors release non-simultaneously
    offers_per_agent: int = 1            # offers per agent per cycle (Mesos: 1)
    batched: bool = False                # batched epoch engine (score once per
                                         # cycle + incremental updates) instead
                                         # of the legacy per-grant recompute
    use_kernel: object = "auto"          # batched epoch backend (see
                                         # OnlineAllocator.allocate_batched)
    async_epochs: bool = False           # overlap device epochs with the event
                                         # loop (deterministic commit points;
                                         # requires batched=True)
    preemption: bool = False             # revocable offers + the epoch-level
                                         # preemption pass (repro.core.preemption)
    preemption_threshold: float = 1.0    # over-share factor for revocability
    preemption_hysteresis: int = 2       # never revoke a grant younger than
                                         # this many epochs (PreemptionPolicy
                                         # .hysteresis_epochs; 0 = off)
    tenancy: object = None               # multi-tenant control plane: None |
                                         # TenancyConfig (repro.core.tenancy).
                                         # Arrivals then route through the
                                         # admission queue on simulator
                                         # virtual time; a job's tenant is
                                         # spec.tenant or its workload group.
    epoch_cache: object = False          # precomputed-epoch cache: False |
                                         # True | byte budget | EpochCache
                                         # (repro.core.epoch_cache; instances
                                         # may be shared across sims)
    audit: bool = False                  # run the ledger invariant auditor
                                         # (repro.core.invariants) after every
                                         # epoch and every processed event
    faults: object = None                # optional repro.core.faults.FaultPlan
                                         # (chaos: crashes/restarts/flaps/racks
                                         # /disconnects/device faults/cache
                                         # corruption on the simulator clock)
    seed: int = 0
    device: str = "cuda"                 # torch device of the fused epochs


@dataclasses.dataclass
class SimResult:
    makespan: float
    timeline: np.ndarray                 # (T, 1+2R): time, allocated[r]..., utilized[r]...
    n_resources: int
    job_durations: dict                  # group -> list[float]
    tasks_speculated: int
    tasks_requeued_on_failure: int
    executors_revoked: int = 0           # preemption: executors killed
    tasks_requeued_on_revoke: int = 0    # preemption: busy tasks requeued
    revoked_wasted_s: float = 0.0        # preemption: task-seconds thrown away
    cache_stats: Optional[dict] = None   # epoch-cache counters (None = no cache)
    fault_stats: Optional[dict] = None   # chaos counters (None = no FaultPlan):
                                         # sim-level churn counts + the
                                         # allocator's fault/recovery counters

    def _series(self, col: int):
        return self.timeline[:, 0], self.timeline[:, col]

    def _twmean(self, col: int) -> float:
        return _metrics.tw_mean(*self._series(col))

    def _twstd(self, col: int) -> float:
        return _metrics.tw_std(*self._series(col))

    # allocated = resources handed to frameworks (incl. coarse-offer slack);
    # utilized  = demand of executors actually running a task right now.
    def mean_util(self, r: int) -> float:
        return self._twmean(1 + r)

    def util_std(self, r: int) -> float:
        return self._twstd(1 + r)

    def mean_used(self, r: int) -> float:
        return self._twmean(1 + self.n_resources + r)

    def used_std(self, r: int) -> float:
        return self._twstd(1 + self.n_resources + r)


class _Job:
    def __init__(self, jid, spec: JobSpec, rng: np.random.Generator, cfg: SimConfig,
                 lane: Optional[str] = None):
        self.jid = jid
        self.spec = spec
        self.lane = lane
        if spec.size_jitter > 0:
            lo = max(1, int(spec.n_tasks * (1 - spec.size_jitter)))
            hi = max(lo + 1, int(spec.n_tasks * (1 + spec.size_jitter)))
            self.n_tasks = int(rng.integers(lo, hi + 1))
        else:  # exact task counts (trace replay, gang streams)
            self.n_tasks = int(spec.n_tasks)
        self.unlaunched = list(range(self.n_tasks))
        self.done: set = set()
        self.running: dict = {}          # task_id -> {copy_id: (executor, t_start, t_end)}
        self.executors: dict = {}        # eid -> agent
        self.idle: list = []             # idle executor ids
        self.submit_time: Optional[float] = None
        self.durations = rng.lognormal(
            mean=np.log(spec.mean_task_s), sigma=0.35, size=self.n_tasks
        )
        strag = rng.random(self.n_tasks) < cfg.straggler_prob
        self.durations = np.where(strag, self.durations * cfg.straggler_factor, self.durations)
        self.speculated: set = set()

    @property
    def complete(self) -> bool:
        return len(self.done) == self.n_tasks

    def wanted(self) -> int:
        live = self.n_tasks - len(self.done)
        return min(self.spec.max_executors, max(live, 0))


class SparkMesosSim:
    """Pure event engine: (agents, workload, hooks) -> completed jobs.

    ``workload`` is a :class:`~repro.core.workloads.WorkloadSource`; a plain
    ``{group: JobSpec}`` dict is accepted for backward compatibility and
    wrapped in a :class:`~repro.core.workloads.SyntheticQueueSource` shaped
    by ``cfg`` (the paper's queue mix)."""

    def __init__(self, agents, workload, cfg: SimConfig,
                 agent_schedule=None, failures=None,
                 hooks: Optional[Sequence] = None):
        """agents: [(name, capacity)]; workload: WorkloadSource or
        {group: JobSpec}; agent_schedule: optional [(time, name, capacity)]
        late registrations; failures: optional [(time, name)] agent failures;
        hooks: optional metrics.SimHook sequence."""
        self.cfg = cfg
        if cfg.async_epochs and not cfg.batched:
            raise ValueError("async_epochs requires batched=True (the "
                             "per-grant path has no dispatch/commit split)")
        self.rng = np.random.default_rng(cfg.seed)
        if isinstance(workload, dict):
            workload = SyntheticQueueSource(
                workload, jobs_per_queue=cfg.jobs_per_queue,
                n_queues_per_group=cfg.n_queues_per_group,
                submit_delay=cfg.submit_delay,
            )
        self.workload = workload
        R = workload.n_resources
        preempt = None
        if cfg.preemption:
            from repro_torch.core.preemption import PreemptionPolicy

            preempt = PreemptionPolicy(
                threshold=cfg.preemption_threshold,
                hysteresis_epochs=cfg.preemption_hysteresis)
        self.alloc = OnlineAllocator(
            n_resources=R, criterion=cfg.criterion, server_policy=cfg.server_policy,
            mode=cfg.mode, bf_metric=cfg.bf_metric, seed=cfg.seed,
            preemption=preempt, epoch_cache=cfg.epoch_cache,
            tenancy=cfg.tenancy, device=cfg.device,
        )
        self.alloc.framework_demand_oracle = self._demand_oracle
        self.jobs: dict[str, _Job] = {}
        self.events: list = []
        self.seq = itertools.count()
        self.now = 0.0
        self._timeline_hook = _metrics.UtilizationTimelineHook()
        self.hooks = (self._timeline_hook, *(hooks or ()))
        self.job_durations: dict = {g: [] for g in workload.groups()}
        self.n_spec = 0
        self.n_requeued = 0
        self.n_revoked = 0               # executors killed by preemption
        self.n_requeued_on_revoke = 0
        self.revoked_wasted_s = 0.0
        self._eid = itertools.count()
        self._alloc_pending = False
        self._pending_arrivals = 0       # scheduled but not yet submitted
        self._inflight = None            # async mode: dispatched, uncommitted

        for name, cap in agents:
            self.alloc.add_agent(name, cap)
        for t, name, cap in (agent_schedule or []):
            self._push(t, "agent_up", (name, cap))
        # legacy permanent-death list: kept verbatim (same event kind, same
        # heap order) so existing seeded traces are untouched; FaultPlan is
        # the richer replacement (crash+restart, flaps, racks, disconnects).
        for t, name in (failures or []):
            self._push(t, "agent_down", name)

        self.fault_plan = cfg.faults
        self.fault_counts = {"agent_crashes": 0, "agent_restarts": 0,
                             "fw_disconnects": 0, "fw_rejoins": 0,
                             "cache_corruptions": 0}
        self.alloc.audit = bool(cfg.audit)
        self.alloc.fault_listeners.append(self._on_alloc_fault)
        if self.fault_plan is not None:
            # chaos rng is private to the harness — fault timing/selection
            # must never perturb the allocator or workload streams.
            self._fault_rng = np.random.default_rng(self.fault_plan.seed)
            self.alloc.fault_injector = self.fault_plan.make_injector()
            for t, ev in self.fault_plan.timed():
                self._push(t, "fault", ev)

    # ------------------------------------------------------------------ util

    def _demand_oracle(self, fid):
        return np.asarray(self.jobs[fid].spec.demand, np.float64)

    def _push(self, t, kind, payload):
        heapq.heappush(self.events, (t, next(self.seq), kind, payload))

    def _sample(self):
        """Emit a telemetry sample to every hook (was the inline _record)."""
        snap = self.alloc.snapshot()
        busy = np.zeros(self.alloc.R)
        for job in self.jobs.values():
            n_busy = sum(len(c) for c in job.running.values())
            busy += np.asarray(job.spec.demand) * min(n_busy, len(job.executors))
        sample = _metrics.Sample(t=self.now, alloc=snap, busy=busy)
        for h in self.hooks:
            h.on_sample(sample)

    # ------------------------------------------------------------ lifecycle

    def _submit(self, arrival: Arrival):
        if arrival.jid in self.jobs or arrival.jid in self.alloc.frameworks:
            raise ValueError(f"duplicate job id {arrival.jid!r}")
        job = _Job(arrival.jid, arrival.spec, self.rng, self.cfg,
                   lane=arrival.lane)
        job.submit_time = self.now
        self.jobs[arrival.jid] = job
        if self.alloc.tenancy is not None:
            # control plane on: the arrival queues for admission (tenant =
            # spec.tenant, defaulting to the workload group) and the gate
            # registers it at the head of a later epoch — on simulator
            # virtual time, so admission latency is a measured quantity.
            self.alloc.submit_admission(
                arrival.jid, demand=job.spec.demand,
                wanted_tasks=job.wanted(),
                tenant=getattr(job.spec, "tenant", None) or job.spec.group,
                now=self.now)
        else:
            self.alloc.register(arrival.jid, demand=job.spec.demand,
                                wanted_tasks=job.wanted())
        for h in self.hooks:
            h.on_submit(self.now, arrival.jid, arrival.spec)

    def _schedule_arrival(self, arrival: Arrival):
        self._pending_arrivals += 1
        self._push(arrival.time, "submit", arrival)

    def _dispatch(self, job: _Job):
        """Idle executors pull microtasks; near the barrier, speculate."""
        while job.idle and job.unlaunched:
            eid = job.idle.pop()
            tid = job.unlaunched.pop(0)
            self._launch(job, tid, eid)
        if self.cfg.speculation and not job.unlaunched:
            self._speculate(job)

    def _launch(self, job: _Job, tid: int, eid: int, duration=None):
        dur = float(job.durations[tid]) if duration is None else duration
        t_end = self.now + dur
        copy = len(job.running.get(tid, {}))
        job.running.setdefault(tid, {})[copy] = (eid, self.now, t_end)
        self._push(t_end, "task_done", (job.jid, tid, copy, eid))

    def _speculate(self, job: _Job):
        if not job.idle or not job.done:
            return
        med = float(np.median([job.durations[t] for t in job.done]))
        for tid, copies in list(job.running.items()):
            if tid in job.speculated or len(copies) > 1:
                continue
            (_, t0, _t_end) = next(iter(copies.values()))
            elapsed = self.now - t0
            if elapsed > self.cfg.spec_multiplier * med and elapsed > self.cfg.spec_min_elapsed:
                if not job.idle:
                    break
                eid = job.idle.pop()
                # relaunch draws a fresh (typically non-straggling) duration
                dur = float(self.rng.lognormal(np.log(job.spec.mean_task_s), 0.35))
                self._launch(job, tid, eid, duration=dur)
                job.speculated.add(tid)
                self.n_spec += 1

    def _finish_job(self, job: _Job):
        duration = self.now - job.submit_time
        self.job_durations.setdefault(job.spec.group, []).append(duration)
        del self.jobs[job.jid]
        for h in self.hooks:
            h.on_finish(self.now, job.jid, job.spec, duration, job.n_tasks)
        # executors release with jitter ("may not simultaneously release");
        # the framework deregisters (freeing coarse-offer slack) last; the
        # lane's next job (if any) arrives per the workload source.
        jmax = 0.0
        for eid, agent in job.executors.items():
            jt = float(self.rng.uniform(0.0, self.cfg.release_jitter))
            jmax = max(jmax, jt)
            self._push(self.now + jt, "release_exec", (job.jid, agent))
        self._push(self.now + jmax + 1e-3, "deregister", job.jid)
        nxt = self.workload.on_finish(job.lane, self.now)
        if nxt is not None:
            self._schedule_arrival(nxt)
        elif job.lane is not None:
            # the lane's (now idle) Spark driver still wakes the allocator
            # one startup-delay later — legacy Mesos-cycle behaviour the
            # grant sequences are pinned to (extra RRR epochs draw from the
            # allocator RNG even when nothing new arrives)
            self._push(self.now + self.cfg.submit_delay, "lane_idle", job.lane)

    def _wanted(self, job: _Job) -> int:
        # Coarse-grained (oblivious) Spark holds max executors until job end;
        # characterized drivers size their ask by remaining work.
        if self.cfg.mode == "oblivious":
            return job.spec.max_executors if not job.complete else 0
        return job.wanted()

    def _mark_dirty(self):
        """Schedule an allocation epoch at the next Mesos allocation cycle."""
        if not self._alloc_pending:
            self._alloc_pending = True
            self._push(self.now + self.cfg.alloc_interval, "alloc", None)

    def _allocate_and_dispatch(self):
        # dying frameworks (job gone, executors draining) want nothing
        for fid in self.alloc.frameworks:
            if fid not in self.jobs:
                self.alloc.set_wanted(fid, 0)
        for jid, job in self.jobs.items():
            if jid in self.alloc.frameworks:   # disconnected drivers (chaos)
                self.alloc.set_wanted(jid, self._wanted(job))
        if self.cfg.async_epochs:
            # dispatch only: the device epoch runs while the event loop
            # keeps moving; _commit_inflight applies the grants at the
            # deterministic commit point (before the next processed event,
            # with `now` still at this epoch's time).  The preemption pass
            # ran inside begin_epoch (its revocations ride on the epoch);
            # executor kills are applied at the commit point too, so async
            # and sync traces see them at identical times and event order.
            self._inflight = self.alloc.begin_epoch(
                per_agent_limit=self.cfg.offers_per_agent,
                use_kernel=self.cfg.use_kernel)
            return
        grants = self.alloc.allocate(per_agent_limit=self.cfg.offers_per_agent,
                                     batched=self.cfg.batched,
                                     use_kernel=self.cfg.use_kernel)
        self._apply_revocations(self.alloc.last_revocations)
        self._apply_grants(grants)

    def _apply_grants(self, grants):
        # admissions of this epoch (the gate ran inside the allocator):
        # surface them to the hooks at the epoch's timestamp — common to
        # the sync path and the async commit point, so both see identical
        # admission times.
        if self.alloc.last_admissions:
            for fid, tenant, t_enq in self.alloc.last_admissions:
                for h in self.hooks:
                    h.on_admission(self.now, fid, tenant,
                                   max(0.0, self.now - t_enq))
            self.alloc.last_admissions.clear()
        for g in grants:
            job = self.jobs[g.fid]
            for _ in range(g.n_executors):
                eid = next(self._eid)
                job.executors[eid] = g.agent
                job.idle.append(eid)
        for h in self.hooks:
            h.on_grant(self.now, grants)
        for job in self.jobs.values():
            self._dispatch(job)
        if grants:
            self._mark_dirty()  # keep cycling while offers land (ramp-up)
        self._sample()
        self._audit()

    def _commit_inflight(self):
        """Commit the in-flight epoch.  `self.now` still equals the
        dispatching epoch's time (no event has been processed since), so
        grant (and revocation-kill) effects land at exactly the synchronous
        path's timestamps."""
        epoch, self._inflight = self._inflight, None
        grants = self.alloc.commit_epoch(epoch)
        self._apply_revocations(epoch.revocations)
        self._apply_grants(grants)

    def _apply_revocations(self, revocations):
        """Kill the executors behind the epoch's revocations (preemption).

        The allocator already reclaimed the resources; here the *work* is
        reconciled: per revocation the victim job loses executors on that
        agent — idle ones first (no work lost; most recently granted first),
        then busy ones whose current task copy started most recently (least
        work thrown away; deterministic tie on executor id).  A killed busy
        copy requeues its task at the queue front when no other copy
        survives — the restart-after-revoke semantics, same as agent
        failure — and its elapsed time is charged to ``revoked_wasted_s``.
        """
        if not revocations:
            return
        wasted = 0.0
        for rev in revocations:
            job = self.jobs.get(rev.fid)
            if job is None:
                continue   # victim is draining (job done): nothing to kill
            need = rev.n_executors
            on_agent = {e for e, a in job.executors.items() if a == rev.agent}
            idle_here = [e for e in job.idle if e in on_agent]
            kill = list(reversed(idle_here))[:need]
            if len(kill) < need:
                # busy executors: (t_start, eid) per running copy, newest
                # first — revoke the copy with the least sunk work
                killed = set(kill)
                busy = []
                for tid, copies in job.running.items():
                    for copy, (eid, t0, _t1) in copies.items():
                        if eid in on_agent and eid not in killed:
                            busy.append((-t0, -eid, eid, tid, copy))
                busy.sort()
                for _nt0, _ne, eid, tid, copy in busy[:need - len(kill)]:
                    kill.append(eid)
                    wasted += self.now - job.running[tid][copy][1]
                    del job.running[tid][copy]
                    if not job.running[tid]:
                        del job.running[tid]
                        job.unlaunched.insert(0, tid)
                        self.n_requeued_on_revoke += 1
            kill_set = set(kill)
            for e in kill:
                job.executors.pop(e, None)
            job.idle = [e for e in job.idle if e not in kill_set]
            self.n_revoked += len(kill)
        self.revoked_wasted_s += wasted
        for h in self.hooks:
            h.on_revoke(self.now, revocations, wasted)

    # ---------------------------------------------------------------- events

    def _on_task_done(self, jid, tid, copy, eid):
        job = self.jobs.get(jid)
        if job is None:
            return
        copies = job.running.get(tid)
        if copies is None or copy not in copies or copies[copy][0] != eid:
            return  # stale event (copy killed / executor lost)
        if tid in job.done:
            return
        job.done.add(tid)
        # free every executor that was running a copy of this task
        for c, (e, _t0, _t1) in copies.items():
            job.idle.append(e)
        del job.running[tid]
        if job.complete:
            self._finish_job(job)
            self._mark_dirty()
        else:
            self._dispatch(job)

    def _on_agent_down(self, name):
        if name not in self.alloc.agents:
            return
        lost = self.alloc.remove_agent(name)
        for fid, _n in lost:
            job = self.jobs.get(fid)
            if job is None:
                continue
            dead = [e for e, a in job.executors.items() if a == name]
            dead_set = set(dead)
            for e in dead:
                del job.executors[e]
            job.idle = [e for e in job.idle if e not in dead_set]
            # requeue tasks whose only running copies were on the dead agent
            for tid, copies in list(job.running.items()):
                live = {c: v for c, v in copies.items() if v[0] not in dead_set}
                if live:
                    job.running[tid] = live
                else:
                    del job.running[tid]
                    job.unlaunched.insert(0, tid)
                    self.n_requeued += 1
        self._mark_dirty()

    # ---------------------------------------------------------------- chaos

    def _on_alloc_fault(self, kind, info):
        """Forward allocator fault/recovery notifications to the hooks."""
        if kind in _faults.RECOVERY_KINDS:
            for h in self.hooks:
                h.on_recovery(self.now, kind, info)
        else:
            for h in self.hooks:
                h.on_fault(self.now, kind, info)

    def _on_fault(self, ev):
        """Apply one timed FaultPlan event (module repro.core.faults)."""
        if isinstance(ev, _faults.AgentCrash):
            cap = self.alloc.agents.get(ev.agent)
            if cap is None:
                return
            self.fault_counts["agent_crashes"] += 1
            for h in self.hooks:
                h.on_fault(self.now, "agent-crash", {"agent": ev.agent})
            self._on_agent_down(ev.agent)
            if ev.restart_after is not None:
                self._push(self.now + ev.restart_after, "fault",
                           _faults.AgentRestart(ev.agent, tuple(cap)))
        elif isinstance(ev, _faults.AgentRestart):
            if ev.agent in self.alloc.agents:
                return   # flap overlap: already back up
            self.fault_counts["agent_restarts"] += 1
            self.alloc.add_agent(ev.agent, ev.capacity)
            self._mark_dirty()
            for h in self.hooks:
                h.on_recovery(self.now, "agent-restart", {"agent": ev.agent})
        elif isinstance(ev, _faults.FrameworkDisconnect):
            job = self.jobs.get(ev.fid)
            if job is None or ev.fid not in self.alloc.frameworks:
                return
            self.fault_counts["fw_disconnects"] += 1
            for h in self.hooks:
                h.on_fault(self.now, "fw-disconnect", {"fid": ev.fid})
            # the driver vanishes: every running copy dies with it and its
            # tasks requeue (restart-on-reregistration, paper §3.7 churn)
            for tid, copies in list(job.running.items()):
                del job.running[tid]
                job.unlaunched.insert(0, tid)
                self.n_requeued += 1
            job.executors.clear()
            job.idle = []
            self.alloc.deregister(ev.fid)
            self._mark_dirty()
            if ev.rejoin_after is not None:
                self._push(self.now + ev.rejoin_after, "fault",
                           _faults.FrameworkRejoin(ev.fid))
        elif isinstance(ev, _faults.FrameworkRejoin):
            job = self.jobs.get(ev.fid)
            if job is None or ev.fid in self.alloc.frameworks:
                return
            self.fault_counts["fw_rejoins"] += 1
            self.alloc.register(ev.fid, demand=job.spec.demand,
                                wanted_tasks=self._wanted(job))
            self._mark_dirty()
            for h in self.hooks:
                h.on_recovery(self.now, "fw-rejoin", {"fid": ev.fid})
        elif isinstance(ev, _faults.CacheCorruption):
            cache = self.alloc.epoch_cache
            if cache is not None and cache.corrupt_entry(self._fault_rng):
                self.fault_counts["cache_corruptions"] += 1
                for h in self.hooks:
                    h.on_fault(self.now, "cache-corrupt", {})

    def _audit(self):
        if self.cfg.audit:
            _invariants.assert_invariants(self.alloc)

    # ------------------------------------------------------------------ run

    def run(self, until: float = float("inf")) -> SimResult:
        for h in self.hooks:
            h.on_start(self)
        for arrival in self.workload.start():
            if arrival.time <= 0.0:
                self._submit(arrival)
            else:
                self._schedule_arrival(arrival)
        self._allocate_and_dispatch()
        while self.now <= until:
            if not self.events:
                if self._inflight is None:
                    break
                self._commit_inflight()   # its grants may push events
                continue
            ev = heapq.heappop(self.events)
            if self._inflight is not None:
                # deterministic commit point: apply the in-flight epoch
                # before processing ANY event.  Committing may insert
                # events earlier than `ev`, so push it back (the original
                # tuple — its sequence number keeps same-time ordering
                # stable) and re-pop.
                heapq.heappush(self.events, ev)
                self._commit_inflight()
                continue
            t, _s, kind, payload = ev
            self.now = t
            if kind == "task_done":
                self._on_task_done(*payload)
            elif kind == "alloc":
                self._alloc_pending = False
                self._allocate_and_dispatch()
            elif kind == "submit":
                self._pending_arrivals -= 1
                self._submit(payload)
                self._mark_dirty()
            elif kind == "lane_idle":
                self._mark_dirty()
            elif kind == "release_exec":
                fid, agent = payload
                fw = self.alloc.frameworks.get(fid)
                if fw is not None and fw.tasks.get(agent):
                    self.alloc.release_executor(fid, agent)
                    self._sample()
                self._mark_dirty()
            elif kind == "deregister":
                if payload in self.alloc.frameworks:
                    self.alloc.deregister(payload)
                    self._sample()
                self._mark_dirty()
            elif kind == "agent_up":
                name, cap = payload
                self.alloc.add_agent(name, cap)
                self._mark_dirty()
            elif kind == "agent_down":
                self._on_agent_down(payload)
            elif kind == "fault":
                self._on_fault(payload)
            self._audit()
            if self._pending_arrivals == 0 and not self.jobs:
                break
        if self._inflight is not None:   # loop ended mid-flight: commit now
            self._commit_inflight()
        self._sample()
        for h in self.hooks:
            h.on_end(self.now)
        R = self.alloc.R
        return SimResult(
            makespan=self.now,
            timeline=self._timeline_hook.timeline(R),
            n_resources=R,
            job_durations=self.job_durations,
            tasks_speculated=self.n_spec,
            tasks_requeued_on_failure=self.n_requeued,
            executors_revoked=self.n_revoked,
            tasks_requeued_on_revoke=self.n_requeued_on_revoke,
            revoked_wasted_s=self.revoked_wasted_s,
            cache_stats=(self.alloc.epoch_cache.stats()
                         if self.alloc.epoch_cache is not None else None),
            fault_stats=(None if self.fault_plan is None
                         else {**self.fault_counts,
                               **self.alloc.fault_counters()}),
        )


# -- the paper's experiment setups ------------------------------------------

# Demands follow the paper §3.3: Pi executors (2 CPU, 2 GB), WordCount
# (1 CPU, 3.5 GB). On the heterogeneous cluster the fluid optimum is exactly
# 12 Pi + 12 WC executors — both resources bind, so packing quality is the
# throughput limiter (as in the paper's Figures 3-5).
PI = JobSpec(group="Pi", demand=(2.0, 2.0), n_tasks=40, mean_task_s=8.0, max_executors=12)
WC = JobSpec(group="WordCount", demand=(1.0, 3.5), n_tasks=40, mean_task_s=8.0, max_executors=12)

HETEROGENEOUS_AGENTS = (
    [(f"type1-{i}", (4.0, 14.0)) for i in range(2)]
    + [(f"type2-{i}", (8.0, 8.0)) for i in range(2)]
    + [(f"type3-{i}", (6.0, 11.0)) for i in range(2)]
)
HOMOGENEOUS_AGENTS = [(f"type3-{i}", (6.0, 11.0)) for i in range(6)]

_batched_parity_ok = False


def assert_batched_parity(seed: int = 0, device: str = "cuda") -> None:
    """Pin the batched epoch engine against the legacy per-grant path.

    Runs one small paper experiment per deterministic server policy both
    ways and asserts the grant sequences are IDENTICAL.  Stochastic RRR is
    deliberately not asserted: the two paths consume the shared RNG stream
    differently (per-grant permutes agents before every grant, the batched
    policy object draws per-round), so sequences differ while remaining
    distributionally equivalent — parity there is covered by the engine's
    own golden/parity suites.  Cached per process (costs ~0.1 s once)."""
    global _batched_parity_ok
    if _batched_parity_ok:
        return
    for crit, pol in (("psdsf", "pooled"), ("rpsdsf", "bestfit")):
        seqs = {}
        for batched in (False, True):
            cfg = SimConfig(criterion=crit, server_policy=pol,
                            mode="characterized", jobs_per_queue=1,
                            seed=seed, batched=batched, device=device)
            hook = _metrics.GrantLogHook()
            sim = SparkMesosSim(HETEROGENEOUS_AGENTS,
                                {"Pi": PI, "WordCount": WC}, cfg, hooks=[hook])
            sim.run()
            seqs[batched] = hook.grants
        if seqs[False] != seqs[True]:
            raise AssertionError(
                f"batched epoch diverged from per-grant path for "
                f"{crit}/{pol} at seed {seed}: "
                f"{seqs[False][:5]}... vs {seqs[True][:5]}..."
            )
    _batched_parity_ok = True


def run_paper_experiment(criterion, mode, agents=None, server_policy="rrr",
                         jobs_per_queue=10, seed=0, batched: bool = False,
                         workload: Optional[WorkloadSource] = None,
                         hooks: Optional[Sequence] = None, **kw) -> SimResult:
    """The paper's §3 experiment: criteria compared on a workload.

    ``workload=None`` builds the paper's synthetic two-group queue mix;
    any :class:`~repro.core.workloads.WorkloadSource` substitutes (trace
    replay, bursty arrivals, ...).  ``batched`` selects the epoch engine —
    honest by construction: the first call in a process asserts per-grant /
    batched grant-sequence parity (see :func:`assert_batched_parity`)."""
    assert_batched_parity(device=kw.get("device", "cuda"))
    cfg = SimConfig(criterion=criterion, server_policy=server_policy, mode=mode,
                    jobs_per_queue=jobs_per_queue, seed=seed, batched=batched,
                    **kw)
    src = workload if workload is not None else {"Pi": PI, "WordCount": WC}
    sim = SparkMesosSim(agents or HETEROGENEOUS_AGENTS, src, cfg, hooks=hooks)
    return sim.run()
