"""Seeded fault injection for the allocator stack (the chaos layer).

The paper's Spark/Mesos stack survives executor loss, agent churn and
speculative re-execution (§3.2, §3.7); Saha et al. (arXiv 1905.08388) make
the stronger point that Mesos fairness claims only hold up when measured
*through* contention and failure events.  This module is the failure-event
vocabulary for our stack:

  * :class:`FaultPlan` — a seeded DSL of *timed* cluster faults driven by
    the simulator clock (agent crash **and restart**, flapping agents,
    correlated rack failures, framework disconnect / re-register, epoch
    cache corruption), superseding the simulator's permanent-death-only
    ``failures=[(t, name)]`` list (still accepted; see
    :meth:`FaultPlan.from_failures`);
  * :class:`EngineFaultInjector` — deterministic injection of
    device-dispatch errors into the fused epoch path (armed counts or a
    seeded Bernoulli rate), consumed by
    :class:`~repro.core.online.OnlineAllocator`'s self-healing dispatch;
  * :class:`RecoveryPolicy` / :class:`DeviceHealth` / :class:`FaultStats` —
    the recovery half: capped exponential backoff for transient retries,
    quarantine of the device path after K consecutive failures (with
    periodic probe epochs to detect recovery), and the counters every layer
    surfaces (`metrics` fault hooks, `alloc_serve` health endpoint,
    `allocator_bench` degraded-mode rows).

Determinism: every stochastic choice here draws from a *private* seeded rng
(never the allocator's) — injecting faults perturbs outcomes only through
the faults themselves, and a plan with no events / zero rates is exactly a
no-op (golden grant sequences are pinned bit-for-bit with faults disabled,
see tests/test_chaos.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Base class of all injected failures (chaos testing)."""


class InjectedDispatchError(InjectedFault):
    """An injected device-dispatch failure (models an XLA/runtime error)."""


class DispatchTimeout(InjectedDispatchError):
    """An injected dispatch timeout.  Handled exactly like a dispatch
    error: the fused epoch path cannot preempt a blocking device call, so
    a timeout is only ever *observed* (by a watchdog or injector), never
    interrupted — recovery re-runs the epoch, it does not cancel it."""


# ---------------------------------------------------------------------------
# recovery configuration + counters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Self-healing dispatch knobs (see docs/robustness.md).

    ``max_retries`` transient re-dispatch attempts per failed epoch, backed
    off exponentially from ``backoff_s`` and capped at ``backoff_cap_s``;
    after ``quarantine_after`` *consecutive* failed fused epochs the device
    path is quarantined (``use_kernel="auto"`` resolves to the host engine,
    device-mesh requests collapse to a single device) until a probe epoch —
    attempted every ``probe_every``-th auto resolution — succeeds."""

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    quarantine_after: int = 3
    probe_every: int = 8

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based): capped exponential."""
        return min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)


def get_recovery(spec) -> RecoveryPolicy:
    """Normalize a ``recovery`` config knob to a :class:`RecoveryPolicy`."""
    if spec is None or spec is True:
        return RecoveryPolicy()
    if isinstance(spec, RecoveryPolicy):
        return spec
    raise ValueError(f"recovery must be None/True/RecoveryPolicy, got {spec!r}")


@dataclasses.dataclass
class FaultStats:
    """Fault/recovery counters of one allocator (merged into
    :meth:`~repro.core.online.OnlineAllocator.fault_counters`)."""

    dispatch_failures: int = 0     # fused dispatch attempts that raised
    commit_failures: int = 0       # handle.result() calls that raised
    retries: int = 0               # backoff retry attempts made
    retry_successes: int = 0       # epochs rescued by a retry
    host_fallbacks: int = 0        # epochs re-run on the host engine
    commit_refusals: int = 0       # mutation-guard aborts at commit
    epoch_aborts: int = 0          # explicit abort_epoch() calls
    cache_corruptions_evicted: int = 0  # digest-failed cache hits evicted

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def restore(self, d: dict) -> None:
        """Overwrite counters from an :meth:`as_dict` payload (journal
        recovery); unknown keys are ignored so old journals keep replaying
        after new counters are added."""
        for k, v in d.items():
            if hasattr(self, k):
                setattr(self, k, int(v))


class DeviceHealth:
    """Consecutive-failure tracking and quarantine of the device path.

    ``on_failure()`` / ``on_success()`` are called once per *fused epoch
    outcome* (a failed epoch = dispatch retries exhausted or a commit that
    fell back to the host); ``allow_auto_device()`` is the gate
    ``use_kernel="auto"`` resolution consults — while quarantined it denies
    the device path except for every ``probe_every``-th attempt (a probe
    epoch), whose success lifts the quarantine."""

    def __init__(self, quarantine_after: int = 3, probe_every: int = 8):
        self.quarantine_after = int(quarantine_after)
        self.probe_every = max(1, int(probe_every))
        self.consecutive_failures = 0
        self.quarantined = False
        self.quarantines = 0       # times the device path was quarantined
        self.probes = 0            # probe epochs attempted while quarantined
        self.probe_successes = 0   # quarantines lifted by a success
        self._probe_tick = 0

    def on_failure(self) -> bool:
        """Record a failed fused epoch; True if this newly quarantined."""
        self.consecutive_failures += 1
        if (not self.quarantined
                and self.consecutive_failures >= self.quarantine_after):
            self.quarantined = True
            self.quarantines += 1
            self._probe_tick = 0
            return True
        return False

    def on_success(self) -> bool:
        """Record a successful fused epoch; True if a quarantine lifted."""
        self.consecutive_failures = 0
        if self.quarantined:
            self.quarantined = False
            self.probe_successes += 1
            return True
        return False

    def allow_auto_device(self) -> bool:
        """May an ``"auto"``-resolved epoch try the device path right now?"""
        if not self.quarantined:
            return True
        self._probe_tick += 1
        if self._probe_tick >= self.probe_every:
            self._probe_tick = 0
            self.probes += 1
            return True
        return False

    def counters(self) -> dict:
        return {
            "quarantined": self.quarantined,
            "consecutive_failures": self.consecutive_failures,
            "quarantines": self.quarantines,
            "probes": self.probes,
            "probe_successes": self.probe_successes,
        }

    def state_dict(self) -> dict:
        """Full durable state: :meth:`counters` plus the probe-cadence tick
        (so a recovered quarantine probes on the same schedule)."""
        out = self.counters()
        out["probe_tick"] = self._probe_tick
        return out

    def restore(self, d: dict) -> None:
        """Overwrite state from a :meth:`state_dict` payload (recovery);
        the quarantine_after/probe_every CONFIG stays the constructor's."""
        self.quarantined = bool(d["quarantined"])
        self.consecutive_failures = int(d["consecutive_failures"])
        self.quarantines = int(d["quarantines"])
        self.probes = int(d["probes"])
        self.probe_successes = int(d["probe_successes"])
        self._probe_tick = int(d.get("probe_tick", 0))


# ---------------------------------------------------------------------------
# device-dispatch error injection
# ---------------------------------------------------------------------------

class EngineFaultInjector:
    """Deterministic injection of device-dispatch / commit errors.

    Two mechanisms, both consulted by the allocator's fused epoch path:
    *armed counts* (``fail_dispatches``/``fail_commits`` or :meth:`arm`)
    fail exactly the next k attempts — fully deterministic, the chaos
    tests' tool of choice — and seeded Bernoulli rates
    (``p_dispatch``/``p_commit``, optionally budgeted by ``max_faults``)
    for randomized chaos sweeps.  The injector draws from its OWN rng:
    the allocator's seeded stream is never touched."""

    def __init__(self, *, fail_dispatches: int = 0, fail_commits: int = 0,
                 p_dispatch: float = 0.0, p_commit: float = 0.0,
                 max_faults: Optional[int] = None, seed: int = 0,
                 timeout: bool = False):
        self._armed_dispatch = int(fail_dispatches)
        self._armed_commit = int(fail_commits)
        self.p_dispatch = float(p_dispatch)
        self.p_commit = float(p_commit)
        self.max_faults = max_faults
        self.timeout = bool(timeout)   # raise DispatchTimeout instead
        self.rng = np.random.default_rng(seed)
        self.injected_dispatch = 0
        self.injected_commit = 0

    def arm(self, n: int = 1, at: str = "dispatch") -> "EngineFaultInjector":
        """Arm the next ``n`` attempts at ``at`` ("dispatch"|"commit")."""
        if at == "dispatch":
            self._armed_dispatch += int(n)
        elif at == "commit":
            self._armed_commit += int(n)
        else:
            raise ValueError(f"arm at must be dispatch|commit, got {at!r}")
        return self

    def _budget_left(self) -> bool:
        return (self.max_faults is None
                or self.injected_dispatch + self.injected_commit
                < self.max_faults)

    def take_dispatch_fault(self) -> bool:
        """One fused dispatch attempt is starting: inject a failure?"""
        if self._armed_dispatch > 0:
            self._armed_dispatch -= 1
            self.injected_dispatch += 1
            return True
        if (self.p_dispatch > 0.0 and self._budget_left()
                and self.rng.random() < self.p_dispatch):
            self.injected_dispatch += 1
            return True
        return False

    def take_commit_fault(self) -> bool:
        """One fused commit (result readback) is starting: inject?"""
        if self._armed_commit > 0:
            self._armed_commit -= 1
            self.injected_commit += 1
            return True
        if (self.p_commit > 0.0 and self._budget_left()
                and self.rng.random() < self.p_commit):
            self.injected_commit += 1
            return True
        return False

    def error(self, where: str) -> InjectedDispatchError:
        cls = DispatchTimeout if self.timeout else InjectedDispatchError
        return cls(f"injected device fault at {where}")

    def counters(self) -> dict:
        return {"injected_dispatch": self.injected_dispatch,
                "injected_commit": self.injected_commit}


# ---------------------------------------------------------------------------
# timed cluster faults (simulator-clock driven)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AgentCrash:
    """Agent goes down at ``time``; restarts ``restart_after`` later with
    its pre-crash capacity (None = permanent — the legacy semantics)."""

    time: float
    agent: str
    restart_after: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class AgentRestart:
    """Internal: scheduled by the simulator when an :class:`AgentCrash`
    carries ``restart_after`` — capacity is captured at crash time."""

    agent: str
    capacity: tuple


@dataclasses.dataclass(frozen=True)
class AgentFlap:
    """A flapping agent: ``cycles`` down/up cycles of ``down_for`` +
    ``up_for`` seconds starting at ``start`` (compiled to crash events)."""

    agent: str
    start: float
    down_for: float
    up_for: float
    cycles: int = 3


@dataclasses.dataclass(frozen=True)
class RackFailure:
    """Correlated failure: every agent in ``agents`` crashes at ``time``
    (and restarts together ``restart_after`` later, if set)."""

    time: float
    agents: tuple
    restart_after: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class FrameworkDisconnect:
    """Framework ``fid`` disconnects at ``time`` (deregisters, loses all
    executors, running work requeues) and re-registers ``rejoin_after``
    later (None = never — the job stalls permanently)."""

    time: float
    fid: str
    rejoin_after: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class FrameworkRejoin:
    """Internal: the re-register half of :class:`FrameworkDisconnect`."""

    fid: str


@dataclasses.dataclass(frozen=True)
class CacheCorruption:
    """Silently perturb one cached epoch outcome at ``time`` (bit-rot /
    poisoned shared cache) — the seq-digest verification on the next hit
    must detect it, evict the entry and fall back to a fresh dispatch."""

    time: float


class FaultPlan:
    """A seeded schedule of faults (builder-style; see the module doc).

        plan = (FaultPlan(seed=7)
                .crash(20.0, "type2-0", restart_after=15.0)
                .flap("type1-1", start=10.0, down_for=4.0, up_for=6.0)
                .rack(35.0, ("type3-0", "type3-1"), restart_after=10.0)
                .disconnect(25.0, "Pi-q0-j0", rejoin_after=8.0)
                .corrupt_cache(40.0)
                .device_errors(p_dispatch=0.2, max_faults=4))

    Passed to the simulator as ``SimConfig(faults=plan)``: timed events
    enter the DES heap, engine error rates become an
    :class:`EngineFaultInjector` installed on the allocator."""

    def __init__(self, events=(), *, p_dispatch: float = 0.0,
                 p_commit: float = 0.0, max_device_faults: Optional[int] = None,
                 seed: int = 0):
        self.events: list = list(events)
        self.p_dispatch = float(p_dispatch)
        self.p_commit = float(p_commit)
        self.max_device_faults = max_device_faults
        self.seed = int(seed)

    # -- builders ------------------------------------------------------------

    def crash(self, time: float, agent: str,
              restart_after: Optional[float] = None) -> "FaultPlan":
        self.events.append(AgentCrash(time, agent, restart_after))
        return self

    def flap(self, agent: str, start: float, down_for: float,
             up_for: float, cycles: int = 3) -> "FaultPlan":
        self.events.append(AgentFlap(agent, start, down_for, up_for, cycles))
        return self

    def rack(self, time: float, agents,
             restart_after: Optional[float] = None) -> "FaultPlan":
        self.events.append(RackFailure(time, tuple(agents), restart_after))
        return self

    def disconnect(self, time: float, fid: str,
                   rejoin_after: Optional[float] = None) -> "FaultPlan":
        self.events.append(FrameworkDisconnect(time, fid, rejoin_after))
        return self

    def corrupt_cache(self, time: float) -> "FaultPlan":
        self.events.append(CacheCorruption(time))
        return self

    def device_errors(self, p_dispatch: float = 0.0, p_commit: float = 0.0,
                      max_faults: Optional[int] = None) -> "FaultPlan":
        self.p_dispatch = float(p_dispatch)
        self.p_commit = float(p_commit)
        self.max_device_faults = max_faults
        return self

    # -- consumption ---------------------------------------------------------

    def timed(self) -> list:
        """(time, event) pairs for the DES heap, flaps/racks expanded to
        crash events, sorted by time (builder order breaks ties)."""
        out = []
        for ev in self.events:
            if isinstance(ev, AgentFlap):
                t = ev.start
                for _ in range(ev.cycles):
                    out.append((t, AgentCrash(t, ev.agent,
                                              restart_after=ev.down_for)))
                    t += ev.down_for + ev.up_for
            elif isinstance(ev, RackFailure):
                for a in ev.agents:
                    out.append((ev.time, AgentCrash(ev.time, a,
                                                    ev.restart_after)))
            else:
                out.append((ev.time, ev))
        out.sort(key=lambda p: p[0])
        return out

    def make_injector(self) -> Optional[EngineFaultInjector]:
        """The device-error half, or None when no rates are configured."""
        if self.p_dispatch <= 0.0 and self.p_commit <= 0.0:
            return None
        return EngineFaultInjector(
            p_dispatch=self.p_dispatch, p_commit=self.p_commit,
            max_faults=self.max_device_faults, seed=self.seed)

    @property
    def empty(self) -> bool:
        return (not self.events and self.p_dispatch <= 0.0
                and self.p_commit <= 0.0)

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_failures(failures) -> "FaultPlan":
        """Wrap a legacy ``failures=[(time, name)]`` list (permanent
        crashes) — migration path off the old simulator parameter."""
        plan = FaultPlan()
        for t, name in failures:
            plan.crash(float(t), name)
        return plan

    @staticmethod
    def random(agents, fids=(), *, horizon: float = 90.0, seed: int = 0,
               intensity: float = 0.5) -> "FaultPlan":
        """A seeded random plan over the given agent names / framework ids
        — the chaos property suite's generator.  ``intensity`` in [0, 1]
        scales how many fault classes fire; every crash restarts (chaos
        runs should exercise recovery, not just shrink the cluster)."""
        rng = np.random.default_rng(seed)
        agents = list(agents)
        fids = list(fids)
        plan = FaultPlan(seed=seed)
        t = lambda lo=0.1, hi=0.6: float(rng.uniform(lo * horizon,
                                                     hi * horizon))
        n_crash = int(rng.integers(1, 1 + max(1, round(2 * intensity))))
        for a in rng.choice(len(agents), size=min(n_crash, len(agents)),
                            replace=False):
            plan.crash(t(), agents[int(a)],
                       restart_after=float(rng.uniform(3.0, 0.2 * horizon)))
        if rng.random() < intensity and len(agents) > 1:
            a = agents[int(rng.integers(len(agents)))]
            plan.flap(a, start=t(0.05, 0.4),
                      down_for=float(rng.uniform(2.0, 6.0)),
                      up_for=float(rng.uniform(3.0, 8.0)),
                      cycles=int(rng.integers(2, 4)))
        if rng.random() < intensity * 0.8 and len(agents) >= 2:
            # correlated rack: agents sharing a name prefix fail together
            prefix = agents[int(rng.integers(len(agents)))].split("-")[0]
            rack = [a for a in agents if a.split("-")[0] == prefix]
            plan.rack(t(0.2, 0.7), rack,
                      restart_after=float(rng.uniform(4.0, 0.2 * horizon)))
        if fids and rng.random() < intensity:
            f = fids[int(rng.integers(len(fids)))]
            plan.disconnect(t(0.1, 0.5), f,
                            rejoin_after=float(rng.uniform(3.0, 12.0)))
        for _ in range(int(rng.integers(0, 3))):
            plan.corrupt_cache(t(0.1, 0.9))
        return plan


#: fault-listener kinds that are *recoveries* (routed to
#: ``SimHook.on_recovery``; everything else goes to ``on_fault``).
RECOVERY_KINDS = frozenset({
    "retry-success", "host-fallback", "probe-success", "agent-restart",
    "fw-rejoin",
})
