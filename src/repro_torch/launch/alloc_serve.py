"""Allocator-as-a-service driver: precomputed-epoch serving front-end.

Distinct from the model-serving driver (:mod:`repro.launch.serve`): this one
serves *allocation decisions*, on the PyTorch port's allocator, which runs
on the card (``device="cuda"``, ``--device cuda``) unless asked for the
CPU.  Incoming allocation requests (framework demand profiles asking for
executors) are batched into allocation epochs through the existing
begin/commit pipeline of :class:`~repro_torch.core.online.OnlineAllocator`,
fronted by the precomputed-epoch cache (:mod:`repro_torch.core.epoch_cache`):
steady-state traffic repeats a small set of (demands, capacities, weights)
profiles, so after the first occurrence of each profile every epoch is a
cache hit — a fingerprint lookup plus a grant replay instead of a device
dispatch.  The driver reports
served-decisions/sec, decision-latency p50/p99
(:class:`~repro_torch.core.metrics.LatencyStats`) and the cache counters.

    PYTHONPATH=src python -m repro_torch.launch.alloc_serve --smoke \
        --device cuda --out SERVE_cache_stats.json

With ``--state-dir`` the service is durable (:mod:`repro_torch.core.journal`):
every mutation is journaled, full snapshots + cache spills land every
``--snapshot-every`` epochs, and restarting on the same directory recovers
the grant ledger, quarantine state and a warm cache — crash-tested by
``--kill-restart-smoke`` (SIGKILL mid-serve, restart, auditor + warm-hit
asserts; the CI chaos job runs it and archives the recovery stats).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core import faults as _faults
from repro_torch.core import invariants as _invariants
from repro_torch.core import journal as _journal
from repro_torch.core import metrics as _metrics
from repro_torch.core.online import OnlineAllocator
from repro_torch.kernels import KernelError

#: demand vectors in quarter multiples (binary-exact f32/f64 arithmetic —
#: release/re-register round-trips reproduce the profile bit-for-bit, the
#: property repeat-profile hits depend on); same convention as
#: benchmarks/allocator_bench.py.
_AGENT_TYPES = ((16.0, 64.0), (32.0, 128.0), (8.0, 32.0), (64.0, 256.0))


class AllocRequest(NamedTuple):
    """One allocation request: a framework asking for executors."""

    fid: str
    demand: tuple          # per-executor demand vector
    n_executors: int       # executors wanted
    phi: float = 1.0       # priority weight
    deadline: Optional[float] = None   # absolute service-clock deadline;
                                       # expired requests are dropped (and
                                       # counted) instead of served late
    tenant: Optional[str] = None       # tenancy lane (defaults to fid when
                                       # the control plane is attached)


class AllocatorService:
    """Batches allocation requests into cached epochs (module docstring).

    ``submit()`` enqueues requests; ``drain_epoch()`` applies the queue to
    the allocator (register / top-up wanted) and runs ONE allocation epoch
    through begin/commit — served from the epoch cache whenever the frozen
    profile has been seen before.  ``complete()`` hands a finished
    framework's executors back (the steady-state release half that makes
    profiles recur).  The cache may be a shared
    :class:`~repro_torch.core.epoch_cache.EpochCache` instance so many service
    replicas serve from one profile table.

    Hardening (docs/robustness.md): ``max_queue`` bounds admission —
    ``submit`` rejects with backpressure once full; per-request
    ``deadline`` s are enforced at drain time (expired requests dropped,
    never served late); a failed epoch is aborted (rng rewound) and
    retried with capped backoff; :meth:`health` reports queue depth,
    rejection/retry counters and the allocator's quarantine state, so a
    load balancer can see a degraded-but-available replica."""

    def __init__(self, n_resources: int, agents: Sequence, *,
                 criterion="drf", server_policy: str = "pooled",
                 epoch_cache=True, use_kernel="auto", seed: int = 0,
                 max_queue: Optional[int] = None, max_retries: int = 2,
                 backoff_s: float = 0.02, clock=time.monotonic,
                 fault_injector=None, recovery=None,
                 state_dir: Optional[str] = None, snapshot_every: int = 16,
                 fsync_every: int = 8, preemption=None, tenancy=None,
                 device="cuda"):
        # tenancy/preemption ride into the allocator BEFORE recovery runs:
        # journal replay of admit-enqueue/admit/credit records requires the
        # control plane to already be attached (journal.py raises otherwise).
        self.alloc = OnlineAllocator(
            n_resources, criterion=criterion, server_policy=server_policy,
            seed=seed, epoch_cache=epoch_cache,
            fault_injector=fault_injector, recovery=recovery,
            preemption=preemption, tenancy=tenancy, device=device)
        # durability (docs/robustness.md): recover FIRST (snapshot + journal
        # replay + warm cache), then attach the live journal, and only seed
        # the agent roster on a genuinely fresh state dir — a recovered one
        # already replayed its own agent-add records.
        self.state_dir = None if state_dir is None else str(state_dir)
        self.snapshot_every = max(1, int(snapshot_every))
        self.recovery_stats: Optional[dict] = None
        self.cache_load_stats: Optional[dict] = None
        recovered = False
        if self.state_dir is not None:
            os.makedirs(self.state_dir, exist_ok=True)
            self.recovery_stats = _journal.recover(self.alloc, self.state_dir)
            recovered = (self.recovery_stats["snapshot_loaded"]
                         or self.recovery_stats["journal_records"] > 0)
            if self.alloc.epoch_cache is not None:
                self.cache_load_stats = self.alloc.epoch_cache.load(
                    os.path.join(self.state_dir, _journal.CACHE_FILE))
            self.alloc.journal = _journal.Journal(
                os.path.join(self.state_dir, _journal.JOURNAL_FILE),
                fsync_every=fsync_every)
        if not recovered:
            for name, cap in agents:
                self.alloc.add_agent(name, cap)
        self.use_kernel = use_kernel
        self.clock = clock
        self.max_queue = max_queue
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.latency = _metrics.LatencyStats()
        self.decisions = 0
        self.epochs = 0
        self.rejected_backpressure = 0
        self.rejected_deadline = 0
        self.coalesced_admissions = 0
        self.epoch_retries = 0
        self.epoch_failures = 0
        self._queue: list[AllocRequest] = []

    def submit(self, req: AllocRequest) -> bool:
        """Admit a request; False = rejected (bounded queue backpressure)."""
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            self.rejected_backpressure += 1
            return False
        self._queue.append(req)
        return True

    def _run_epoch_with_retry(self) -> list:
        """One epoch through begin/commit; on failure abort the in-flight
        epoch (rng rewound — the retry re-draws the same stream) and retry
        with backoff.  The allocator's own self-healing (device retries,
        host fallback, quarantine) runs underneath; this layer only covers
        errors that escape it.  A :class:`~repro_torch.kernels.KernelError`
        is never retried: a kernel that does not build, launch or run is
        not transient."""
        last = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.epoch_retries += 1
                if self.backoff_s > 0:
                    time.sleep(min(self.backoff_s * 2 ** (attempt - 1), 1.0))
            try:
                return self.alloc.commit_epoch(
                    self.alloc.begin_epoch(use_kernel=self.use_kernel))
            except KernelError:
                self.alloc.abort_epoch()
                self.epoch_failures += 1
                raise
            except Exception as exc:
                self.alloc.abort_epoch()
                last = exc
        self.epoch_failures += 1
        raise last

    def drain_epoch(self) -> list:
        """Apply queued requests, run one (cached) epoch, return grants."""
        now = self.clock()
        live = []
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self.rejected_deadline += 1
                continue
            live.append(req)
        for req in live:
            fw = self.alloc.frameworks.get(req.fid)
            if fw is None:
                if self.alloc.tenancy is not None:
                    # per-tenant admission lane: the arrival queues in the
                    # control plane and the admission gate at the top of the
                    # next epoch registers it in demand-aware order.  A fid
                    # already queued coalesces (counted, not re-enqueued).
                    if self.alloc.tenancy.has_queued(req.fid):
                        self.coalesced_admissions += 1
                    else:
                        self.alloc.submit_admission(
                            req.fid, demand=req.demand,
                            wanted_tasks=req.n_executors, phi=req.phi,
                            tenant=req.tenant, now=now)
                else:
                    self.alloc.register(req.fid, demand=req.demand,
                                        wanted_tasks=req.n_executors,
                                        phi=req.phi)
            else:
                self.alloc.set_wanted(
                    req.fid, fw.wanted_tasks + req.n_executors)
        self._queue.clear()
        t0 = time.perf_counter()
        grants = self._run_epoch_with_retry()
        dt = time.perf_counter() - t0
        self.latency.record(dt, max(len(grants), 1))
        self.decisions += len(grants)
        self.epochs += 1
        if (self.state_dir is not None
                and self.epochs % self.snapshot_every == 0):
            self.checkpoint()
        return grants

    def checkpoint(self) -> None:
        """Persist a full snapshot + cache spill into the state dir (no-op
        without one).  Bounds recovery replay to the records appended
        since; runs automatically every ``snapshot_every`` epochs."""
        if self.state_dir is None:
            return
        _journal.write_snapshot(self.state_dir, self.alloc,
                                self.alloc.journal)
        if self.alloc.epoch_cache is not None:
            self.alloc.epoch_cache.save(
                os.path.join(self.state_dir, _journal.CACHE_FILE))

    def close(self) -> None:
        """Final checkpoint + journal close (clean shutdown; a SIGKILL
        skips this and recovery picks up from the journal instead)."""
        self.checkpoint()
        if self.alloc.journal is not None:
            self.alloc.journal.close()
            self.alloc.journal = None

    def complete(self, fid: str) -> None:
        """A framework finished: release its executors and deregister —
        freed capacity re-enters the pool, the profile can recur."""
        fw = self.alloc.frameworks.get(fid)
        if fw is None:
            return
        for agent in list(fw.tasks):
            while fw.tasks.get(agent):
                self.alloc.release_executor(fid, agent)
        self.alloc.deregister(fid)

    def counters(self) -> dict:
        """Reset-free monotonic counters snapshot (reading never mutates
        anything — dashboards can poll at any cadence).  Includes the
        journal-lag view: records appended since the last fsync (the
        power-loss exposure window) and since the last snapshot (the
        recovery replay length), so durability lag is alertable."""
        out = {
            "epochs": self.epochs,
            "decisions": self.decisions,
            "queue_depth": len(self._queue),
            "rejected_backpressure": self.rejected_backpressure,
            "rejected_deadline": self.rejected_deadline,
            "epoch_retries": self.epoch_retries,
            "epoch_failures": self.epoch_failures,
            "coalesced_admissions": self.coalesced_admissions,
            "journal_lag_fsync": 0,
            "journal_lag_snapshot": 0,
        }
        if self.alloc.tenancy is not None:
            out["admissions"] = self.alloc.tenancy.counters()
        if self.alloc.journal is not None:
            jc = self.alloc.journal.counters()
            out["journal"] = jc
            out["journal_lag_fsync"] = jc["records_since_fsync"]
            out["journal_lag_snapshot"] = jc["records_since_snapshot"]
        return out

    def health(self) -> dict:
        """Liveness/degradation endpoint: ``status`` is ``"degraded"``
        while the device path is quarantined (serving continues on the
        host engine), ``"ok"`` otherwise."""
        out = {
            "status": ("degraded" if self.alloc.device_health.quarantined
                       else "ok"),
            "queue_depth": len(self._queue),
            "rejected_backpressure": self.rejected_backpressure,
            "rejected_deadline": self.rejected_deadline,
            "epoch_retries": self.epoch_retries,
            "epoch_failures": self.epoch_failures,
            "faults": self.alloc.fault_counters(),
            "counters": self.counters(),
        }
        if self.alloc.tenancy is not None:
            out["admissions"] = self.alloc.tenancy.counters()
        return out

    def stats(self) -> dict:
        cache = self.alloc.epoch_cache
        out = {
            "epochs": self.epochs,
            "decisions": self.decisions,
            "latency": self.latency.summary(),
            "cache": cache.stats() if cache is not None else None,
            "health": self.health(),
        }
        if self.recovery_stats is not None:
            out["recovery"] = dict(self.recovery_stats)
            out["cache_load"] = (None if self.cache_load_stats is None
                                 else dict(self.cache_load_stats))
        return out


def make_profiles(n_profiles: int, n_frameworks: int, n_resources: int = 2,
                  seed: int = 0) -> list:
    """Distinct repeat-profiles: request batches with quantized demands."""
    rng = np.random.default_rng(seed)
    profiles = []
    for p in range(n_profiles):
        reqs = []
        for i in range(n_frameworks):
            d = tuple(0.25 * int(rng.integers(1, 9))
                      for _ in range(n_resources))
            reqs.append(AllocRequest(fid=f"fw{i}", demand=d,
                                     n_executors=int(rng.integers(2, 9)),
                                     phi=float(1 + (i % 3))))
        profiles.append(reqs)
    return profiles


def drive(service: AllocatorService, profiles: list, rounds: int,
          round_sleep: float = 0.0) -> dict:
    """Serve ``rounds`` request batches cycling over the profile set.

    Each round submits one profile's requests, drains an epoch, and
    completes every framework (executors release, capacity returns), so
    from the second cycle on every epoch replays from the cache.
    ``round_sleep`` throttles the loop (the kill-restart smoke uses it to
    widen the mid-serve window it SIGKILLs into).  Returns the service
    stats plus wall-clock throughput."""
    t0 = time.perf_counter()
    for r in range(rounds):
        for req in profiles[r % len(profiles)]:
            service.submit(req)
        grants = service.drain_epoch()
        for fid in {g.fid for g in grants}:
            service.complete(fid)
        # frameworks whose demand fit nowhere still leave the roster, so
        # the next round's registration recreates the profile exactly
        for fid in list(service.alloc.frameworks):
            service.complete(fid)
        if round_sleep > 0:
            time.sleep(round_sleep)
    wall = time.perf_counter() - t0
    out = service.stats()
    out["wall_s"] = wall
    out["decisions_per_s"] = service.decisions / max(wall, 1e-12)
    return out


def serve(n_agents: int = 64, n_frameworks: int = 40, n_profiles: int = 4,
          rounds: int = 64, criterion: str = "drf",
          server_policy: str = "pooled", use_kernel="auto",
          epoch_cache=True, seed: int = 0,
          inject_faults: bool = False, state_dir: Optional[str] = None,
          snapshot_every: int = 16, round_sleep: float = 0.0,
          device="cuda") -> dict:
    agents = [(f"a{j}", _AGENT_TYPES[j % len(_AGENT_TYPES)])
              for j in range(n_agents)]
    injector = recovery = None
    if inject_faults:
        # chaos serve: force the fused path, fail its first dispatches, and
        # quarantine quickly — proves degraded-mode serving stays available
        # (host fallback) and the health endpoint reports it (CI chaos job).
        use_kernel = "fused"
        injector = _faults.EngineFaultInjector(fail_dispatches=6, seed=seed)
        recovery = _faults.RecoveryPolicy(max_retries=0, backoff_s=0.0,
                                          quarantine_after=2, probe_every=4)
    service = AllocatorService(
        2, agents, criterion=criterion, server_policy=server_policy,
        epoch_cache=epoch_cache, use_kernel=use_kernel, seed=seed,
        fault_injector=injector, recovery=recovery,
        state_dir=state_dir, snapshot_every=snapshot_every, device=device)
    profiles = make_profiles(n_profiles, n_frameworks, seed=seed)
    out = drive(service, profiles, rounds, round_sleep=round_sleep)
    if state_dir is not None:
        service.close()
    out["config"] = {
        "n_agents": n_agents, "n_frameworks": n_frameworks,
        "n_profiles": n_profiles, "rounds": rounds, "criterion": criterion,
        "server_policy": server_policy, "use_kernel": str(use_kernel),
        "epoch_cache": bool(epoch_cache), "seed": seed,
        "inject_faults": bool(inject_faults),
        "state_dir": state_dir, "snapshot_every": snapshot_every,
        "device": str(device),
    }
    return out


def kill_restart_smoke(state_dir: str, out_path: Optional[str] = None, *,
                       seed: int = 0, n_agents: int = 16,
                       n_frameworks: int = 8, n_profiles: int = 3,
                       wait_s: float = 60.0, device="cuda") -> dict:
    """Crash-recovery smoke (CI chaos job): SIGKILL a serving subprocess
    mid-flight, restart on the same ``--state-dir``, and prove the
    recovered replica is whole — the PR-8 invariant auditor is green on
    the recovered ledger and the reloaded cache serves its first repeat
    profile as a HIT (warm restart, no re-dispatch)."""
    import pathlib
    import signal  # noqa: F401  (documents the delivery; kill() sends it)
    import subprocess
    import sys

    sd = pathlib.Path(state_dir)
    sd.mkdir(parents=True, exist_ok=True)
    for name in (_journal.JOURNAL_FILE, _journal.SNAPSHOT_FILE,
                 _journal.CACHE_FILE):
        (sd / name).unlink(missing_ok=True)
    env = dict(os.environ)
    src_root = pathlib.Path(__file__).resolve().parents[2]
    env["PYTHONPATH"] = os.pathsep.join(
        [str(src_root)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.alloc_serve",
         "--agents", str(n_agents), "--frameworks", str(n_frameworks),
         "--profiles", str(n_profiles), "--rounds", "1000000",
         "--round-sleep", "0.002", "--seed", str(seed),
         "--state-dir", str(sd), "--snapshot-every", "4",
         "--device", str(device)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if ((sd / _journal.SNAPSHOT_FILE).exists()
                    and (sd / _journal.CACHE_FILE).exists()):
                break
            if child.poll() is not None:
                raise RuntimeError("serve child exited before its first "
                                   "snapshot (crashed at startup?)")
            time.sleep(0.05)
        else:
            raise RuntimeError(f"serve child wrote no snapshot in {wait_s}s")
        time.sleep(0.3)   # run PAST the snapshot so the kill lands on a
    finally:              # journal tail (and likely an open epoch bracket)
        child.kill()      # SIGKILL: no atexit, no flush, no close()
        child.wait()

    service = AllocatorService(
        2, [(f"a{j}", _AGENT_TYPES[j % len(_AGENT_TYPES)])
            for j in range(n_agents)],
        seed=seed, state_dir=str(sd), device=device)
    stats = {"recovery": dict(service.recovery_stats),
             "cache_load": dict(service.cache_load_stats)}
    errs = _invariants.check(service.alloc)
    assert errs == [], f"recovered ledger failed the auditor: {errs}"
    assert (stats["recovery"]["snapshot_loaded"]
            or stats["recovery"]["journal_records"] > 0), \
        f"restart recovered nothing: {stats['recovery']}"
    assert stats["cache_load"]["loaded"] > 0, \
        f"warm cache loaded no entries: {stats['cache_load']}"
    cache = service.alloc.epoch_cache
    h0, m0 = cache.hits, cache.misses
    # the killed run's leftover frameworks release (dyadic demands: the
    # round-trip is bit-exact), then the first repeat profile must be a hit
    for fid in list(service.alloc.frameworks):
        service.complete(fid)
    for req in make_profiles(n_profiles, n_frameworks, seed=seed)[0]:
        service.submit(req)
    service.drain_epoch()
    assert cache.hits == h0 + 1 and cache.misses == m0, \
        (f"warm restart did not serve the repeat profile from cache: "
         f"hits {h0}->{cache.hits}, misses {m0}->{cache.misses}")
    stats["warm_hit"] = True
    stats["ledger_invariants"] = "green"
    stats["counters"] = service.counters()
    service.close()
    print(f"kill-restart smoke OK: replayed "
          f"{stats['recovery']['replayed_records']} records past lsn "
          f"{stats['recovery']['snapshot_lsn']}, recovered aborts "
          f"{stats['recovery']['recovered_aborts']}, warm cache "
          f"{stats['cache_load']['loaded']} entries -> first repeat hit")
    if out_path:
        path = pathlib.Path(out_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(stats, indent=2))
        print(f"wrote {path}")
    return stats


def multi_tenant_smoke(out_path: Optional[str] = None, *,
                       n_tenants: int = 3, floor: float = 0.3,
                       n_agents: int = 8, rounds: int = 24, seed: int = 0,
                       criterion: str = "drf",
                       server_policy: str = "rrr", device="cuda") -> dict:
    """Multi-tenant serve smoke (CI tenancy job): ``n_tenants`` admission
    lanes with tenant ``t0`` floor-protected, preemption on, and a bounded
    admission gate (2/epoch against 3 arrivals/round) so queue pressure —
    and therefore the demand-aware ordering and credit queue-jumps — is
    actually exercised.  Asserts the PR-8 auditor is green on the final
    ledger, admissions flowed, at least one credit jump fired, and the
    per-tenant ledger conserves (``accrued - spent == balance``); writes
    the admission-stats artifact the CI job uploads."""
    from repro_torch.core.preemption import PreemptionPolicy
    from repro_torch.core.tenancy import TenancyConfig

    agents = [(f"a{j}", _AGENT_TYPES[j % len(_AGENT_TYPES)])
              for j in range(n_agents)]
    tcfg = TenancyConfig(floors=(("t0", float(floor)),),
                         queue_jump_cost=2.0, shield_cost=4.0,
                         max_admissions_per_epoch=2)
    service = AllocatorService(
        2, agents, criterion=criterion, server_policy=server_policy,
        seed=seed, preemption=PreemptionPolicy(), tenancy=tcfg,
        device=device)
    cp = service.alloc.tenancy
    rng = np.random.default_rng(seed)
    admission_wait = _metrics.LatencyStats()
    n_fids = 0
    shielded = False
    for r in range(rounds):
        for t in range(n_tenants):
            d = tuple(0.25 * int(rng.integers(1, 6)) for _ in range(2))
            service.submit(AllocRequest(
                fid=f"t{t}-fw{n_fids}", demand=d,
                n_executors=int(rng.integers(1, 4)), tenant=f"t{t}"))
            n_fids += 1
        service.drain_epoch()
        for _fid, _tenant, t_enq in service.alloc.last_admissions:
            admission_wait.record(max(0.0, service.clock() - t_enq))
        service.alloc.last_admissions.clear()
        # spend accrued credits as soon as a queued lane can afford a
        # jump (ahead of every non-jumped entry) / the floor tenant can
        # afford a revocation shield — exercises both spend paths.
        for e in cp.queue:
            if not e.jumped and cp.balance(e.tenant) >= tcfg.queue_jump_cost:
                service.alloc.spend_queue_jump(e.fid)
                break
        if not shielded and cp.balance("t0") >= tcfg.shield_cost:
            service.alloc.spend_shield("t0")
            shielded = True
        # churn: retire the two oldest frameworks every third round so
        # capacity returns and later admissions land on a warm cluster
        if r % 3 == 2:
            for fid in list(service.alloc.frameworks)[:2]:
                service.complete(fid)
    errs = _invariants.check(service.alloc)
    assert errs == [], f"tenancy smoke: auditor violations: {errs}"
    c = cp.counters()
    assert c["admission_admitted_total"] > 0, "no admissions flowed"
    assert c["admission_enqueued_total"] == (
        c["admission_admitted_total"] + c["admission_queued"]), \
        f"admission counters do not balance: {c}"
    assert c["credit_jumps"] >= 1, f"credit queue-jump never fired: {c}"
    for t in sorted(set(cp.accrued) | set(cp.spent) | set(cp.credits)):
        lhs = cp.accrued.get(t, 0.0) - cp.spent.get(t, 0.0)
        assert abs(lhs - cp.balance(t)) < 1e-9, \
            f"tenant {t} ledger drifted: {lhs} != {cp.balance(t)}"
    stats = {
        "config": {"n_tenants": n_tenants, "floor": floor,
                   "floor_tenant": "t0", "n_agents": n_agents,
                   "rounds": rounds, "seed": seed, "criterion": criterion,
                   "server_policy": server_policy},
        "admissions": c,
        "admission_wait": admission_wait.summary(),
        "credits": cp.credit_state(),
        "tenant_shares": {t: round(v, 6) for t, v in
                          sorted(service.alloc._tenant_shares().items())},
        "epochs": service.epochs,
        "decisions": service.decisions,
        "health": service.health(),
        "ledger_invariants": "green",
    }
    print(f"tenancy smoke OK: admitted "
          f"{c['admission_admitted_total']}/{c['admission_enqueued_total']} "
          f"(queued {c['admission_queued']}), jumps {c['credit_jumps']}, "
          f"shields {c['credit_shields']}, decisions {service.decisions}")
    if out_path:
        import pathlib

        path = pathlib.Path(out_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(stats, indent=2))
        print(f"wrote {path}")
    return stats


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--frameworks", type=int, default=40)
    ap.add_argument("--profiles", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--criterion", default="drf")
    ap.add_argument("--policy", default="pooled",
                    choices=("pooled", "rrr", "bestfit"))
    ap.add_argument("--kernel", default="auto")
    ap.add_argument("--no-cache", action="store_true",
                    help="serve without the epoch cache (baseline)")
    ap.add_argument("--smoke", action="store_true",
                    help="small fixed workload + cache-effectiveness assert")
    ap.add_argument("--inject-faults", action="store_true",
                    help="chaos serve: fused path with injected dispatch "
                         "failures; with --smoke asserts degraded-mode "
                         "serving stays available (host fallback + "
                         "quarantine reported by the health endpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the allocator (cuda or cpu)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="with --smoke: run the multi-tenant admission "
                         "smoke with this many tenant lanes (t0 "
                         "floor-protected, preemption on) and write the "
                         "admission-stats artifact to --out")
    ap.add_argument("--floor", type=float, default=0.3,
                    help="quota floor (fraction of pooled capacity) for "
                         "tenant t0 in the multi-tenant smoke")
    ap.add_argument("--out", default=None, help="write stats JSON here")
    ap.add_argument("--state-dir", default=None,
                    help="durable state directory (journal + snapshots + "
                         "cache spill); restarting on the same dir recovers "
                         "the ledger and warm cache")
    ap.add_argument("--snapshot-every", type=int, default=16,
                    help="full snapshot + cache spill cadence, in epochs")
    ap.add_argument("--round-sleep", type=float, default=0.0,
                    help="throttle between serve rounds, seconds")
    ap.add_argument("--kill-restart-smoke", action="store_true",
                    help="chaos: SIGKILL a serving subprocess mid-flight, "
                         "restart on the same --state-dir, assert recovered "
                         "ledger invariants + a warm-cache repeat hit")
    args = ap.parse_args(argv)

    if args.kill_restart_smoke:
        return kill_restart_smoke(args.state_dir or "serve-state",
                                  args.out, seed=args.seed,
                                  device=args.device)
    if args.smoke and args.tenants > 0:
        return multi_tenant_smoke(args.out, n_tenants=args.tenants,
                                  floor=args.floor, seed=args.seed,
                                  criterion=args.criterion,
                                  server_policy=args.policy,
                                  device=args.device)
    if args.smoke:
        args.agents, args.frameworks = min(args.agents, 64), 40
        args.profiles, args.rounds = 4, 32
    out = serve(n_agents=args.agents, n_frameworks=args.frameworks,
                n_profiles=args.profiles, rounds=args.rounds,
                criterion=args.criterion, server_policy=args.policy,
                use_kernel=args.kernel, epoch_cache=not args.no_cache,
                seed=args.seed, inject_faults=args.inject_faults,
                state_dir=args.state_dir,
                snapshot_every=args.snapshot_every,
                round_sleep=args.round_sleep, device=args.device)
    if args.smoke and args.inject_faults:
        health = out["health"]
        faults = health["faults"]
        # degraded-mode availability: every round still served an epoch,
        # decisions flowed, and the failure actually exercised the fallback
        assert out["epochs"] == args.rounds, \
            f"chaos smoke: served {out['epochs']}/{args.rounds} epochs"
        assert out["decisions"] > 0, "chaos smoke: no decisions served"
        assert faults["host_fallbacks"] >= 1, \
            f"chaos smoke: host fallback never fired ({faults})"
        assert faults["quarantines"] >= 1, \
            f"chaos smoke: device path never quarantined ({faults})"
        print(f"chaos smoke OK: status={health['status']} "
              f"fallbacks={faults['host_fallbacks']} "
              f"quarantines={faults['quarantines']} "
              f"decisions={out['decisions']}")
    elif args.smoke and not args.no_cache:
        cache = out["cache"]
        # every round past the first profile cycle must replay from cache
        expect = args.rounds - args.profiles
        assert cache["hits"] >= expect, \
            f"serve smoke: {cache['hits']} hits < {expect} expected " \
            f"({cache})"
        print(f"serve smoke OK: hit_rate={cache['hit_rate']:.3f} "
              f"({cache['hits']}/{cache['hits'] + cache['misses']})")
    print(json.dumps({k: out[k] for k in
                      ("decisions", "wall_s", "decisions_per_s")},
                     indent=2))
    if args.out:
        import pathlib

        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=2))
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
