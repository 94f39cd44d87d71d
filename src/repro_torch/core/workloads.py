"""Workload sources for the Spark-on-Mesos discrete-event simulator.

Ownership split (see also :mod:`repro.core.metrics`):

  * **workloads own *what arrives when*** — which jobs exist, their specs,
    and the submission process (closed-loop queue chaining or open-loop
    timestamped arrivals);
  * **metrics own *what is measured*** (:mod:`repro.core.metrics`);
  * **the simulator owns *event ordering only*** — it executes tasks,
    stragglers, failures and allocation epochs, but invents no jobs and
    records no telemetry of its own.

A :class:`WorkloadSource` hands the simulator :class:`Arrival` records.  Two
submission regimes compose through one interface:

  * *closed loop* (the paper's §3 queue mixes): each submission lane holds a
    queue of jobs; the next job of a lane is released a fixed driver-startup
    delay after the previous one finishes.  :meth:`WorkloadSource.start`
    returns the lane heads (``time=0``) and :meth:`WorkloadSource.on_finish`
    chains the rest.
  * *open loop* (trace replay, bursty/heavy-tailed generators, gang-job
    streams): every arrival is timestamped up front; :meth:`start` returns
    them all and :meth:`on_finish` returns ``None``.

Determinism contract: sources never touch the simulator's RNG.  Job-level
randomness (task-count jitter, task durations, stragglers) stays inside the
simulator, drawn from ``SimConfig.seed`` at submission time — this is what
makes the extracted :class:`SyntheticQueueSource` reproduce the pre-refactor
``run_paper_experiment`` results bit-for-bit (golden-tested).  Generator
sources (:func:`heavy_tailed_arrivals`, :func:`bursty_arrivals`) use their
own seed to materialize the arrival sequence once, at construction.
"""
from __future__ import annotations

import csv
import dataclasses
import json
from typing import Iterable, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Per-job workload shape (one Spark job == one Mesos framework)."""

    group: str
    demand: tuple            # per-executor resources
    n_tasks: int = 40        # mean microtasks per job (jittered per job)
    mean_task_s: float = 8.0
    max_executors: int = 12
    size_jitter: float = 0.5  # n_tasks ~ U[(1-j)*n, (1+j)*n] — staggers churn
    tenant: Optional[str] = None  # multi-tenant control plane: the tenant
                                  # this job bills to (None = its group)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One timestamped job submission handed to the simulator."""

    time: float              # absolute simulation time of submission
    jid: str                 # unique job / framework id
    spec: JobSpec
    lane: Optional[str] = None  # closed-loop chaining key (None = open loop)


class WorkloadSource:
    """Interface: a stream of timestamped :class:`Arrival` submissions.

    Closed-loop sources are stateful (lanes drain as jobs are handed out) —
    construct a fresh one per simulation.  Open-loop sources replay their
    fixed schedule and may be reused across runs."""

    def groups(self) -> tuple:
        """Distinct job groups this source can emit (for result bookkeeping)."""
        raise NotImplementedError

    @property
    def n_resources(self) -> int:
        raise NotImplementedError

    def start(self) -> list:
        """All arrivals known at t=0: lane heads (closed loop, ``time=0``)
        and/or the full pre-materialized schedule (open loop)."""
        raise NotImplementedError

    def on_finish(self, lane: Optional[str], now: float) -> Optional[Arrival]:
        """Closed-loop chaining: the lane's next submission after a finish
        (or None).  Open-loop sources always return None."""
        return None


class SyntheticQueueSource(WorkloadSource):
    """The paper's synthetic queue mix (extracted from ``SparkMesosSim``).

    Each group (Pi: CPU-bound, WordCount: memory-bound) gets
    ``n_queues_per_group`` lanes of ``jobs_per_queue`` jobs; every lane
    submits sequentially, the next job ``submit_delay`` seconds (Spark
    driver startup) after the previous one completes.
    """

    def __init__(self, specs: dict, jobs_per_queue: int = 10,
                 n_queues_per_group: int = 5, submit_delay: float = 3.0):
        self.specs = dict(specs)
        self.submit_delay = float(submit_delay)
        self._group_of: dict[str, str] = {}
        self._queues: dict[str, list] = {}
        for g in self.specs:
            for q in range(n_queues_per_group):
                qid = f"{g}-q{q}"
                self._queues[qid] = [f"{qid}-j{i}" for i in range(jobs_per_queue)]
                self._group_of[qid] = g

    def groups(self) -> tuple:
        return tuple(self.specs)

    @property
    def n_resources(self) -> int:
        return len(next(iter(self.specs.values())).demand)

    def _pop(self, qid: str, t: float) -> Optional[Arrival]:
        q = self._queues.get(qid)
        if not q:
            return None
        jid = q.pop(0)
        return Arrival(time=t, jid=jid, spec=self.specs[self._group_of[qid]],
                       lane=qid)

    def start(self) -> list:
        return [a for a in (self._pop(qid, 0.0) for qid in list(self._queues))
                if a is not None]

    def on_finish(self, lane, now) -> Optional[Arrival]:
        if lane is None:
            return None
        return self._pop(lane, now + self.submit_delay)


class OpenLoopSource(WorkloadSource):
    """A fixed, pre-materialized arrival schedule (open loop)."""

    def __init__(self, arrivals: Iterable[Arrival]):
        arr = sorted(arrivals, key=lambda a: a.time)
        if not arr:
            raise ValueError("open-loop workload needs at least one arrival")
        seen = set()
        for a in arr:
            if a.jid in seen:
                raise ValueError(f"duplicate job id {a.jid!r} in workload")
            seen.add(a.jid)
        self.arrivals = arr

    def groups(self) -> tuple:
        out: list[str] = []
        for a in self.arrivals:
            if a.spec.group not in out:
                out.append(a.spec.group)
        return tuple(out)

    @property
    def n_resources(self) -> int:
        return len(self.arrivals[0].spec.demand)

    def start(self) -> list:
        return list(self.arrivals)


# -- arrival-process generators ---------------------------------------------

def _pick_specs(specs: dict, n: int, rng, group_weights=None):
    import numpy as np

    groups = list(specs)
    p = None
    if group_weights is not None:
        w = np.asarray([group_weights[g] for g in groups], np.float64)
        p = w / w.sum()
    picks = rng.choice(len(groups), size=n, p=p)
    return [specs[groups[int(i)]] for i in picks]


def heavy_tailed_arrivals(specs: dict, n_jobs: int = 60,
                          mean_interarrival_s: float = 6.0,
                          alpha: float = 1.5, seed: int = 0,
                          group_weights=None) -> OpenLoopSource:
    """Pareto(alpha) interarrivals: long quiet stretches + clumps of jobs.

    ``alpha`` close to 1 is heavier-tailed; interarrivals are scaled so the
    mean stays ``mean_interarrival_s`` (for alpha > 1).
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    gaps = mean_interarrival_s * max(alpha - 1.0, 1e-3) * rng.pareto(alpha, n_jobs)
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    chosen = _pick_specs(specs, n_jobs, rng, group_weights)
    return OpenLoopSource(
        Arrival(time=float(t), jid=f"ht-j{i}", spec=s)
        for i, (t, s) in enumerate(zip(times, chosen))
    )


def bursty_arrivals(specs: dict, n_bursts: int = 8, burst_size: int = 6,
                    burst_gap_s: float = 45.0, jitter_s: float = 2.0,
                    seed: int = 0, group_weights=None) -> OpenLoopSource:
    """Bursts of near-simultaneous submissions separated by quiet gaps —
    the arrival shape that stresses new-framework priority and churn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrivals = []
    chosen = _pick_specs(specs, n_bursts * burst_size, rng, group_weights)
    for b in range(n_bursts):
        t0 = b * burst_gap_s
        for k in range(burst_size):
            t = t0 + float(rng.uniform(0.0, jitter_s))
            i = b * burst_size + k
            arrivals.append(Arrival(time=t, jid=f"burst{b}-j{k}", spec=chosen[i]))
    return OpenLoopSource(arrivals)


def gang_arrivals(gang_jobs: Sequence, arrival_gap_s: float = 10.0,
                  mean_task_s: float = 120.0,
                  tasks_per_unit: int = 4) -> OpenLoopSource:
    """Bridge accelerator gang jobs (``repro.cluster.gang.JobSpec`` or any
    object with ``name``/``arch``/``demand``/``gang_units_wanted``) into a
    DES job stream: each gang unit is an executor slot, each unit runs
    ``tasks_per_unit`` long microtasks (training segments between
    checkpoints).  Demands are the gang scheduler's R=4 vectors
    (chips, HBM, host RAM, ICI), so the same criteria compare on
    accelerator-shaped resources."""
    arrivals = []
    for i, j in enumerate(gang_jobs):
        spec = JobSpec(
            group=getattr(j, "arch", None) or j.name,
            demand=tuple(float(x) for x in j.demand),
            n_tasks=int(j.gang_units_wanted) * tasks_per_unit,
            mean_task_s=mean_task_s,
            max_executors=int(j.gang_units_wanted),
            size_jitter=0.0,  # gang work is sized up front, not sampled
        )
        arrivals.append(Arrival(time=i * arrival_gap_s, jid=f"gang-{j.name}",
                                spec=spec))
    return OpenLoopSource(arrivals)


# -- trace replay ------------------------------------------------------------

_TRACE_FIELDS = ("arrival_s", "group", "n_tasks", "mean_task_s", "max_executors")


class TraceReplaySource(OpenLoopSource):
    """Replay a Spark-style job trace (JSON or CSV).

    JSON schema::

        {"resources": ["cpus", "mem_gb"],
         "jobs": [{"arrival_s": 0.0, "group": "Pi", "demand": [2.0, 2.0],
                   "n_tasks": 40, "mean_task_s": 8.0, "max_executors": 12,
                   "job_id": "optional"}, ...]}

    CSV schema: header ``arrival_s,group,n_tasks,mean_task_s,max_executors,
    demand_0,demand_1,...`` (one demand_<r> column per resource).

    Traces are replayed open loop: arrival times come from the trace, task
    counts are exact (``size_jitter=0``), and a given (trace, SimConfig.seed)
    pair yields a deterministic simulation (round-trip tested).
    """

    def __init__(self, arrivals: Iterable[Arrival], resources: tuple = ()):
        super().__init__(arrivals)
        self.resources = tuple(resources)
        want_r = len(self.resources) or len(self.arrivals[0].spec.demand)
        for a in self.arrivals:
            if len(a.spec.demand) != want_r:
                raise ValueError(
                    f"trace job {a.jid!r}: demand has {len(a.spec.demand)} "
                    f"entries, expected {want_r}"
                )

    @classmethod
    def from_file(cls, path: str) -> "TraceReplaySource":
        if path.endswith(".csv"):
            return cls._from_csv(path)
        return cls._from_json(path)

    @classmethod
    def _from_json(cls, path: str) -> "TraceReplaySource":
        with open(path) as f:
            doc = json.load(f)
        resources = tuple(doc.get("resources", ()))
        arrivals = [
            cls._arrival(i, rec, tuple(rec.get("demand") or ()))
            for i, rec in enumerate(doc["jobs"])
        ]
        return cls(arrivals, resources)

    @classmethod
    def _from_csv(cls, path: str) -> "TraceReplaySource":
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        if not rows:
            raise ValueError(f"empty trace {path!r}")
        dcols = sorted((c for c in rows[0] if c.startswith("demand_")),
                       key=lambda c: int(c.split("_")[1]))
        if not dcols:
            raise ValueError(f"trace {path!r} has no demand_<r> columns")
        arrivals = [
            cls._arrival(i, rec, tuple(float(rec[c]) for c in dcols))
            for i, rec in enumerate(rows)
        ]
        return cls(arrivals)

    @staticmethod
    def _arrival(i: int, rec: dict, demand: tuple) -> Arrival:
        missing = [k for k in _TRACE_FIELDS if k not in rec or rec[k] in ("", None)]
        if not demand:
            missing.append("demand")
        if missing:
            raise ValueError(f"trace job #{i} missing fields {missing}")
        spec = JobSpec(
            group=str(rec["group"]),
            demand=tuple(float(x) for x in demand),
            n_tasks=int(rec["n_tasks"]),
            mean_task_s=float(rec["mean_task_s"]),
            max_executors=int(rec["max_executors"]),
            size_jitter=0.0,  # traces record exact task counts
        )
        return Arrival(time=float(rec["arrival_s"]),
                       jid=str(rec.get("job_id") or f"trace-j{i}"), spec=spec)
