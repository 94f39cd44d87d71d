"""Fault tolerance for the training runtime: heartbeats, straggler
mitigation (the paper's speculative-execution mechanism lifted to the
training fleet), and elastic rescale.

The paper's Spark layer (§3.2) handles faults with three techniques —
microtasking, pull-based executors, and speculative re-execution at
barriers.  The analogous training-fleet mechanisms implemented here:

  * microtasking        -> micro-batch grad accumulation (train/steps.py)
  * executor pull       -> per-host data shards pulled from a deterministic
                           stream (data/pipeline.py) — any host can take over
                           any row range after a rescale
  * speculative exec    -> StragglerMonitor: per-host step-time EMA; hosts
                           slower than `threshold x median` are flagged for
                           eviction/replacement at the next checkpoint
                           boundary (a training step is a barrier: one
                           straggler stalls the whole all-reduce, so unlike
                           Spark we evict rather than duplicate)
  * churn               -> ElasticController: on membership change, restore
                           the latest checkpoint onto the new mesh
                           (checkpoint/store.py reshard-on-load) and
                           re-partition the data stream
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_ema: Optional[float] = None


class VirtualClock:
    """A settable clock for driving the monitors on simulator virtual time.

    Pass an instance as ``clock=`` (it is callable) and advance it from the
    DES loop — or ignore it entirely and pass explicit ``now=`` timestamps
    to :meth:`HeartbeatMonitor.beat` / :meth:`HeartbeatMonitor.failed_hosts`.
    """

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def __call__(self) -> float:
        return self.t


class HeartbeatMonitor:
    """Liveness tracking; a host silent for `timeout` is declared failed.

    ``clock`` defaults to wall time but accepts any zero-arg callable — a
    :class:`VirtualClock` runs the monitor end-to-end on simulator virtual
    time; every query also takes an explicit ``now=`` override for callers
    that carry their own timestamps (the DES event loop's ``sim.now``)."""

    def __init__(self, n_hosts: int, timeout: float = 60.0, clock=time.monotonic):
        self.clock = clock
        self.timeout = timeout
        self.hosts = {h: HostState(h, clock()) for h in range(n_hosts)}

    def beat(self, host_id: int, now: Optional[float] = None):
        self.hosts[host_id].last_heartbeat = (
            self.clock() if now is None else float(now))

    def failed_hosts(self, now: Optional[float] = None) -> list:
        t = self.clock() if now is None else float(now)
        return [h for h, st in self.hosts.items()
                if t - st.last_heartbeat > self.timeout]


class StragglerMonitor:
    """Per-host step-time EMA; flags hosts slower than threshold x median.

    This is the paper's speculative-execution policy adapted to synchronous
    SPMD training: the 'barrier' is every train step, so chronic stragglers
    are evicted (and their rows re-assigned) instead of duplicated.
    """

    def __init__(self, n_hosts: int, alpha: float = 0.2, threshold: float = 1.5,
                 min_steps: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.min_steps = min_steps
        self.ema = {h: None for h in range(n_hosts)}
        self.counts = {h: 0 for h in range(n_hosts)}

    def record(self, host_id: int, step_time: float):
        e = self.ema[host_id]
        self.ema[host_id] = step_time if e is None else (
            (1 - self.alpha) * e + self.alpha * step_time
        )
        self.counts[host_id] += 1

    def stragglers(self) -> list:
        vals = [e for h, e in self.ema.items()
                if e is not None and self.counts[h] >= self.min_steps]
        if len(vals) < 3:
            return []
        med = float(np.median(vals))
        return [
            h for h, e in self.ema.items()
            if e is not None and self.counts[h] >= self.min_steps
            and e > self.threshold * med
        ]


@dataclasses.dataclass
class RescalePlan:
    old_hosts: int
    new_hosts: int
    restore_step: int
    reason: str


class ElasticController:
    """Drives checkpoint/restore-based elastic rescale.

    Orchestrates: detect membership change (failures from HeartbeatMonitor,
    evictions from StragglerMonitor, or scale-up offers from the cluster
    layer) -> emit a RescalePlan -> the launcher rebuilds the mesh, restores
    the latest checkpoint with new shardings, re-partitions the data stream.
    """

    def __init__(self, heartbeat: HeartbeatMonitor, stragglers: StragglerMonitor,
                 latest_step: Callable[[], Optional[int]]):
        self.heartbeat = heartbeat
        self.stragglers = stragglers
        self.latest_step = latest_step

    def plan(self, current_hosts: int, offered_hosts: int = 0) -> Optional[RescalePlan]:
        failed = set(self.heartbeat.failed_hosts())
        slow = set(self.stragglers.stragglers())
        drop = failed | slow
        new = current_hosts - len(drop) + offered_hosts
        if new == current_hosts:
            return None
        step = self.latest_step() or 0
        reason = []
        if failed:
            reason.append(f"failed={sorted(failed)}")
        if slow:
            reason.append(f"stragglers={sorted(slow)}")
        if offered_hosts:
            reason.append(f"scale_up=+{offered_hosts}")
        return RescalePlan(current_hosts, new, step, ", ".join(reason))
