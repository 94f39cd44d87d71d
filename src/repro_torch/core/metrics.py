"""Fairness-over-time telemetry for the Spark-on-Mesos simulator.

Ownership split (see also :mod:`repro.core.workloads`):

  * **workloads own *what arrives when*** (:mod:`repro.core.workloads`);
  * **metrics own *what is measured*** — every timeline, fairness index and
    slowdown statistic lives here, computed from allocator snapshots through
    an event-hook protocol;
  * **the simulator owns *event ordering only*** — it calls hooks at
    well-defined points and keeps no inline telemetry of its own.

Hook protocol (:class:`SimHook`): the simulator calls

  * ``on_start(sim)`` once before the first allocation epoch;
  * ``on_sample(sample)`` after every state change it used to record
    (allocation epochs, releases, deregistrations) with a :class:`Sample`:
    the wall-clock, an :class:`~repro.core.online.AllocSnapshot` of the
    allocator (per-framework usage vs. pooled capacity) and the demand
    vector of executors actively running tasks;
  * ``on_submit(t, jid, spec)`` / ``on_finish(t, jid, spec, duration,
    n_tasks)`` around each job's lifetime;
  * ``on_end(t)`` when the run stops.

The vectorized helpers (:func:`tw_mean`, :func:`tw_std`,
:func:`dominant_shares`, :func:`jain_index`) are exposed separately so
offline consumers (benchmarks, notebooks) can apply the same formulas to
recorded series — ``SimResult`` delegates its time-weighted moments here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


# ---------------------------------------------------------------------------
# vectorized building blocks
# ---------------------------------------------------------------------------

def tw_mean(t, v) -> float:
    """Time-weighted mean of a left-constant step series v(t)."""
    t = np.asarray(t, np.float64)
    v = np.asarray(v, np.float64)
    if len(t) < 2:
        return 0.0
    dt = np.diff(t)
    return float(np.sum(v[:-1] * dt) / max(np.sum(dt), 1e-12))


def tw_std(t, v) -> float:
    """Time-weighted standard deviation of a left-constant step series."""
    t = np.asarray(t, np.float64)
    v = np.asarray(v, np.float64)
    if len(t) < 2:
        return 0.0
    dt = np.diff(t)
    m = tw_mean(t, v)
    return float(np.sqrt(np.sum((v[:-1] - m) ** 2 * dt) / max(np.sum(dt), 1e-12)))


def dominant_shares(usage, cap_total, phi=None) -> np.ndarray:
    """(N,) weighted dominant shares max_r usage_{n,r} / (phi_n * sum_j c_{j,r}).

    The quantity DRF equalizes — computed on *held* resources (executors +
    coarse-offer slack), so oblivious-mode waste shows up as inflated shares.
    """
    usage = np.asarray(usage, np.float64)
    if usage.size == 0:
        return np.zeros(0)
    cap = np.maximum(np.asarray(cap_total, np.float64), 1e-30)
    s = np.max(usage / cap[None, :], axis=1)
    if phi is not None:
        s = s / np.maximum(np.asarray(phi, np.float64), 1e-30)
    return s


def jain_index(x) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) in [1/n, 1].

    1.0 = perfectly equal shares.  Defined as 1.0 for empty input or
    all-zero shares (nobody is being treated unequally)."""
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 1.0
    sq = float(np.sum(x * x))
    if sq <= 0.0:
        return 1.0
    return float(np.sum(x)) ** 2 / (x.size * sq)


def slowdown(duration: float, spec, n_tasks: Optional[int] = None) -> float:
    """Job slowdown vs. its perfectly-parallel ideal runtime.

    ideal = ceil(n_tasks / max_executors) * mean_task_s — the job's serial
    work spread over the executors it asked for, no queueing, no stragglers.
    """
    n = int(n_tasks if n_tasks is not None else spec.n_tasks)
    waves = max(1, -(-n // max(spec.max_executors, 1)))
    ideal = waves * spec.mean_task_s
    return float(duration) / max(ideal, 1e-12)


# ---------------------------------------------------------------------------
# hook protocol
# ---------------------------------------------------------------------------

class Sample(NamedTuple):
    """One telemetry sample emitted by the simulator."""

    t: float
    alloc: "AllocSnapshot"   # repro.core.online.AllocSnapshot
    busy: np.ndarray         # (R,) demand of executors actively running tasks


class SimHook:
    """Base class: all callbacks are optional no-ops."""

    def on_start(self, sim) -> None:
        pass

    def on_sample(self, sample: Sample) -> None:
        pass

    def on_submit(self, t: float, jid: str, spec) -> None:
        pass

    def on_grant(self, t: float, grants) -> None:
        pass

    def on_finish(self, t: float, jid: str, spec, duration: float,
                  n_tasks: int) -> None:
        pass

    def on_revoke(self, t: float, revocations, wasted_s: float) -> None:
        """Preemption: a batch of executor revocations was applied.
        ``revocations`` is the epoch's ordered
        :class:`~repro.core.preemption.Revocation` list; ``wasted_s`` is the
        task-seconds of in-flight work thrown away by this batch.  Only
        called for non-empty batches, so hook streams with preemption off
        are identical to pre-preemption runs."""
        pass

    def on_admission(self, t: float, fid: str, tenant: str,
                     wait_s: float) -> None:
        """Tenancy (repro.core.tenancy): the admission gate admitted a
        queued arrival at simulator time ``t`` after ``wait_s`` seconds in
        the queue.  Only called when a control plane is attached, so hook
        streams with tenancy off are identical to pre-tenancy runs."""
        pass

    def on_fault(self, t: float, kind: str, info: dict) -> None:
        """Chaos (repro.core.faults): a fault fired — an injected agent
        crash / framework disconnect / cache corruption, or an allocator-
        level failure (dispatch/commit error, quarantine, commit refusal).
        Only called on actual fault events, so hook streams of fault-free
        runs are identical to pre-chaos runs."""
        pass

    def on_recovery(self, t: float, kind: str, info: dict) -> None:
        """Chaos: a recovery action succeeded (retry-success, host-fallback,
        probe-success, agent-restart, fw-rejoin).  Same no-fault-stream
        guarantee as :meth:`on_fault`."""
        pass

    def on_end(self, t: float) -> None:
        pass


class FaultLogHook(SimHook):
    """Records every fault and recovery event (the chaos suite's witness):
    ``faults`` / ``recoveries`` hold (t, kind, info) tuples, ``counts``
    aggregates per kind."""

    def __init__(self):
        self.faults: list = []
        self.recoveries: list = []
        self.counts: dict = {}

    def on_fault(self, t, kind, info) -> None:
        self.faults.append((t, kind, info))
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def on_recovery(self, t, kind, info) -> None:
        self.recoveries.append((t, kind, info))
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def summary(self) -> dict:
        return {"n_faults": len(self.faults),
                "n_recoveries": len(self.recoveries),
                "counts": dict(self.counts)}


class GrantLogHook(SimHook):
    """Records the exact grant sequence (fid, agent, n_executors) — the
    engine-parity witness used by ``assert_batched_parity`` — and, with
    preemption enabled, the revocation sequence alongside."""

    def __init__(self):
        self.grants: list = []
        self.revoked: list = []

    def on_grant(self, t, grants) -> None:
        self.grants.extend((g.fid, g.agent, g.n_executors) for g in grants)

    def on_revoke(self, t, revocations, wasted_s) -> None:
        self.revoked.extend((r.fid, r.agent, r.n_executors)
                            for r in revocations)


class PreemptionHook(SimHook):
    """Preemption telemetry: revocation counts, wasted work, and the
    cumulative-revocations-over-time series (churn pressure)."""

    def __init__(self):
        self.t: list = []
        self.cumulative: list = []
        self.n_revocations = 0
        self.executors_revoked = 0
        self.wasted_s = 0.0

    def on_revoke(self, t, revocations, wasted_s) -> None:
        self.n_revocations += len(revocations)
        self.executors_revoked += sum(r.n_executors for r in revocations)
        self.wasted_s += float(wasted_s)
        self.t.append(t)
        self.cumulative.append(self.executors_revoked)

    def summary(self) -> dict:
        return {
            "n_revocations": self.n_revocations,
            "executors_revoked": self.executors_revoked,
            "revoked_wasted_s": self.wasted_s,
        }


class UtilizationTimelineHook(SimHook):
    """The legacy ``SimResult.timeline`` rows: (t, allocated_r..., utilized_r...).

    allocated = fraction of pooled capacity handed to frameworks (including
    coarse-offer slack); utilized = demand of executors actively running a
    task.  Bit-for-bit identical to the pre-refactor inline ``_record``.
    """

    def __init__(self):
        self.rows: list = []

    def on_sample(self, sample: Sample) -> None:
        snap = sample.alloc
        if snap.cap_total is None:
            return
        cap = np.maximum(snap.cap_total, 1e-30)
        allocated = (snap.cap_total - snap.free_total) / cap
        self.rows.append((sample.t, *allocated, *(sample.busy / cap)))

    def timeline(self, n_resources: int) -> np.ndarray:
        if not self.rows:
            return np.zeros((0, 1 + 2 * n_resources))
        return np.array(self.rows)


class FairnessTimelineHook(SimHook):
    """Fairness-over-time: per-framework dominant shares, Jain's index, and
    per-group aggregate shares at every sample point."""

    def __init__(self):
        self.t: list = []
        self.jain: list = []
        self.group_share: dict[str, list] = {}
        self._group_of: dict[str, str] = {}
        self._per_fw: list = []       # (t, fids, shares) ragged trajectory

    def on_submit(self, t, jid, spec) -> None:
        self._group_of[jid] = spec.group
        if spec.group not in self.group_share:
            # groups discovered mid-run held zero share until now
            self.group_share[spec.group] = [0.0] * len(self.t)

    def on_sample(self, sample: Sample) -> None:
        snap = sample.alloc
        if snap.cap_total is None:  # no agents registered (total failure)
            return
        s = dominant_shares(snap.usage, snap.cap_total, snap.phi)
        self.t.append(sample.t)
        self.jain.append(jain_index(s))
        self._per_fw.append((sample.t, snap.fids, s))
        by_group: dict[str, float] = {g: 0.0 for g in self.group_share}
        for fid, sh in zip(snap.fids, s):
            g = self._group_of.get(fid)
            if g is not None:
                by_group[g] = by_group.get(g, 0.0) + float(sh)
        for g, series in self.group_share.items():
            series.append(by_group.get(g, 0.0))

    def jain_series(self) -> tuple:
        return np.asarray(self.t), np.asarray(self.jain)

    def summary(self) -> dict:
        t = np.asarray(self.t)
        jain = np.asarray(self.jain)
        return {
            "jain_tw_mean": tw_mean(t, jain),
            "jain_min": float(jain.min()) if jain.size else 1.0,
            "group_share_tw_mean": {
                g: tw_mean(t, np.asarray(v)) for g, v in self.group_share.items()
            },
        }


class LatencyStats:
    """Streaming decision-latency accumulator (seconds in, ms out).

    Used by the allocator serving front-end (``repro.launch.alloc_serve``)
    and the cache-stats hook: record one latency per allocation decision
    (or per epoch), read p50/p99 off the retained samples.  Retention is
    capped — beyond ``max_samples`` a uniform thinning (keep every 2nd)
    halves the series, which keeps quantiles representative without an
    unbounded buffer in week-long serve runs."""

    def __init__(self, max_samples: int = 1 << 20):
        self.max_samples = int(max_samples)
        self.n = 0
        self.total_s = 0.0
        self._samples: list = []

    def record(self, seconds: float, count: int = 1) -> None:
        """One timed span covering ``count`` decisions (an epoch granting
        k executors records k decisions at seconds/k each)."""
        self.n += count
        self.total_s += float(seconds)
        self._samples.append(float(seconds) / max(count, 1))
        if len(self._samples) > self.max_samples:
            self._samples = self._samples[::2]

    def percentile_ms(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), q)) * 1e3

    def summary(self) -> dict:
        return {
            "decisions": self.n,
            "total_s": self.total_s,
            "mean_ms": (self.total_s / self.n * 1e3) if self.n else 0.0,
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
        }


class CacheStatsHook(SimHook):
    """Epoch-cache telemetry: final hit/miss/eviction counters plus the
    hit-rate trajectory over simulated time (steady-state workloads climb
    toward 1.0 as the profile set saturates the cache).

    Reads ``sim.alloc.epoch_cache`` at start — inert (empty summary) when
    the allocator runs without a cache, so wiring the hook unconditionally
    costs nothing."""

    def __init__(self):
        self.cache = None
        self.t: list = []
        self.hit_rate: list = []

    def on_start(self, sim) -> None:
        self.cache = getattr(sim.alloc, "epoch_cache", None)

    def on_sample(self, sample: Sample) -> None:
        if self.cache is None:
            return
        self.t.append(sample.t)
        self.hit_rate.append(self.cache.hit_rate)

    def summary(self) -> dict:
        if self.cache is None:
            return {}
        return dict(self.cache.stats())


class JournalStatsHook(SimHook):
    """Durability telemetry: final journal counters plus the fsync-lag
    trajectory (records appended since the last fsync / snapshot — the
    window a power loss could lose, what the serve health endpoint
    alerts on).

    Reads ``sim.alloc.journal`` at start — inert (empty summary) when the
    allocator runs without a journal, so wiring the hook unconditionally
    costs nothing."""

    def __init__(self):
        self.journal = None
        self.t: list = []
        self.fsync_lag: list = []
        self.snapshot_lag: list = []

    def on_start(self, sim) -> None:
        self.journal = getattr(sim.alloc, "journal", None)

    def on_sample(self, sample: Sample) -> None:
        if self.journal is None:
            return
        self.t.append(sample.t)
        self.fsync_lag.append(self.journal.records_since_fsync)
        self.snapshot_lag.append(self.journal.records_since_snapshot)

    def summary(self) -> dict:
        if self.journal is None:
            return {}
        return dict(self.journal.counters())


class TenancyHook(SimHook):
    """Multi-tenant control-plane telemetry (repro.core.tenancy).

    Per tenant: admission latency (:class:`LatencyStats` over simulator
    virtual time), SLO attainment (fraction of finished jobs whose
    :func:`slowdown` stays at or under ``slo_slowdown`` — default 8.0,
    roughly the mean slowdown of the contended paper scenarios, so
    attainment discriminates between tenants instead of saturating), aggregate
    dominant-share trajectory and the final Jain index across tenants,
    plus the final credit balances.

    Reads ``sim.alloc.tenancy`` at start — inert (empty summary) when the
    allocator runs without a control plane, so wiring the hook
    unconditionally costs nothing."""

    def __init__(self, slo_slowdown: float = 8.0):
        self.slo_slowdown = float(slo_slowdown)
        self.cp = None
        self.admission: dict[str, LatencyStats] = {}
        self.slo: dict[str, list] = {}          # tenant -> [met: bool]
        self._tenant_of: dict[str, str] = {}    # fid -> tenant
        self.t: list = []
        self.tenant_jain: list = []
        self._share_series: dict[str, list] = {}

    def on_start(self, sim) -> None:
        self.cp = getattr(sim.alloc, "tenancy", None)

    def on_submit(self, t, jid, spec) -> None:
        if self.cp is None:
            return
        self._tenant_of[jid] = getattr(spec, "tenant", None) or spec.group

    def on_admission(self, t, fid, tenant, wait_s) -> None:
        self._tenant_of[fid] = tenant
        self.admission.setdefault(tenant, LatencyStats()).record(wait_s)

    def on_finish(self, t, jid, spec, duration, n_tasks) -> None:
        if self.cp is None:
            return
        tenant = self._tenant_of.get(
            jid, getattr(spec, "tenant", None) or spec.group)
        met = slowdown(duration, spec, n_tasks) <= self.slo_slowdown
        self.slo.setdefault(tenant, []).append(bool(met))

    def on_sample(self, sample: Sample) -> None:
        if self.cp is None:
            return
        snap = sample.alloc
        if snap.cap_total is None:
            return
        shares = dominant_shares(snap.usage, snap.cap_total)
        by_tenant: dict[str, float] = {}
        for fid, sh in zip(snap.fids, shares):
            tenant = self._tenant_of.get(fid, fid)
            by_tenant[tenant] = by_tenant.get(tenant, 0.0) + float(sh)
        self.t.append(sample.t)
        self.tenant_jain.append(
            jain_index(list(by_tenant.values())) if by_tenant else 1.0)
        for tenant, sh in by_tenant.items():
            self._share_series.setdefault(
                tenant, [0.0] * (len(self.t) - 1)).append(sh)
        for tenant, series in self._share_series.items():
            if len(series) < len(self.t):
                series.append(0.0)

    def summary(self) -> dict:
        if self.cp is None:
            return {}
        t = np.asarray(self.t)
        jain = np.asarray(self.tenant_jain)
        return {
            "tenant_jain_tw_mean": tw_mean(t, jain),
            "tenant_jain_min": float(jain.min()) if jain.size else 1.0,
            "admission": {ten: st.summary()
                          for ten, st in sorted(self.admission.items())},
            "slo_attainment": {
                ten: (float(np.mean(v)) if v else 1.0)
                for ten, v in sorted(self.slo.items())},
            "tenant_share_tw_mean": {
                ten: tw_mean(t, np.asarray(v))
                for ten, v in sorted(self._share_series.items())},
            "counters": self.cp.counters(),
        }


class SlowdownHook(SimHook):
    """Per-group job slowdowns (observed duration / perfectly-parallel ideal)."""

    def __init__(self):
        self.by_group: dict[str, list] = {}

    def on_finish(self, t, jid, spec, duration, n_tasks) -> None:
        self.by_group.setdefault(spec.group, []).append(
            slowdown(duration, spec, n_tasks)
        )

    def summary(self) -> dict:
        out = {}
        for g, v in self.by_group.items():
            a = np.asarray(v)
            out[g] = {
                "n": int(a.size),
                "mean": float(a.mean()),
                "p95": float(np.percentile(a, 95)),
                "max": float(a.max()),
            }
        return out
