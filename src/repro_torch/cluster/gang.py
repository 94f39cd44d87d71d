"""THE PAPER AS A FLEET FEATURE: fair gang-scheduling of training/serving
jobs onto heterogeneous TPU pod slices.

Mapping (see DESIGN.md §2):
  framework n  -> job (one of the assigned archs x shape, or anything else)
  server j     -> pod slice type (chips, HBM GB, host-RAM GB, ICI GB/s share)
  task         -> gang unit: the smallest mesh slice the job can use
  d_{n,r}      -> per-gang-unit demand derived from the job's DRY-RUN
                  artifact (param+temp bytes/device, collective bytes/step)
                  — i.e. the dry-run IS the paper's "workload characterization"

The allocator is the paper's online allocator (repro.core.online); all its
criteria (DRF/TSF/PS-DSF/rPS-DSF/BF-DRF) apply unchanged.  For fleets large
enough that scoring matters (10k x 10k), `repro_torch.kernels.psdsf_score`
provides the fused scoring/argmin (the CUDA kernel K4 on the card).  The
scheduler's allocator runs on the card (``device="cuda"``) unless asked for
the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from repro_torch.core.online import OnlineAllocator

# resource vector: (chips, HBM GiB, host-RAM GiB, ICI GB/s share)
RESOURCES = ("chips", "hbm_gib", "host_ram_gib", "ici_gbps")

# v5e-flavored slice catalog (capacity per agent)
SLICE_TYPES = {
    "v5e-64-fat-host": (64.0, 1024.0, 2048.0, 1600.0),
    "v5e-64": (64.0, 1024.0, 512.0, 1600.0),
    "v5e-32-highici": (32.0, 512.0, 256.0, 1600.0),
}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    name: str
    arch: str
    shape: str
    gang_units_wanted: int          # how many gang units the job can use
    demand: tuple                   # per gang unit, aligned with RESOURCES
    priority: float = 1.0           # phi weight (higher = larger fair share)
    allowed_slice_types: tuple = () # placement constraints (empty = any)


def demand_from_dryrun(artifact_path: str, gang_chips: int = 16) -> tuple:
    """Workload characterization from the dry-run artifact (paper §3.1's
    'characterized mode' — the demand vector comes from the compiled cell).
    """
    art = json.load(open(artifact_path))
    per_dev = art["param_bytes_per_device"]
    temp = (art.get("memory_analysis") or {}).get("temp_bytes", 0) or 0
    hbm_gib = (per_dev + temp) * gang_chips / 2**30
    # ICI demand: collective bytes per step / chips, expressed as GB/s at a
    # nominal 1 step/s cadence (relative load is what the packer needs)
    ici = art["total_collective_bytes"] / 1e9
    host_ram = 2.0 * gang_chips  # host staging buffers, GiB
    return (float(gang_chips), float(hbm_gib), float(host_ram), float(ici))


class GangScheduler:
    """Online fair gang scheduler over a dynamic slice fleet.

    ``criterion`` may be a name or a
    :class:`repro_torch.core.criteria.Criterion` strategy object.
    ``batched=True`` runs epochs through the incremental
    :class:`repro_torch.core.engine.BatchedEpoch` engine (score once per
    epoch, the fleet-scale fast path) instead of the legacy per-grant
    recompute.  ``device`` is the torch device of the allocator."""

    def __init__(self, criterion="rpsdsf", server_policy: str = "rrr",
                 mode: str = "characterized", seed: int = 0,
                 batched: bool = False, device="cuda"):
        self.alloc = OnlineAllocator(
            n_resources=len(RESOURCES), criterion=criterion,
            server_policy=server_policy, mode=mode, seed=seed,
            device=device,
        )
        self.batched = batched
        self.jobs: dict[str, JobSpec] = {}
        self.slice_types: dict[str, str] = {}
        self.alloc.framework_demand_oracle = lambda fid: np.asarray(
            self.jobs[fid].demand
        )

    # fleet membership ---------------------------------------------------------
    def add_slice(self, name: str, slice_type: str):
        self.alloc.add_agent(name, SLICE_TYPES[slice_type])
        self.slice_types[name] = slice_type

    def fail_slice(self, name: str) -> list:
        """Returns [(job, gang_units_lost)] — feeds ElasticController."""
        return self.alloc.remove_agent(name)

    # job lifecycle ------------------------------------------------------------
    def submit(self, job: JobSpec):
        self.jobs[job.name] = job
        allowed = None
        if job.allowed_slice_types:
            allowed = [a for a, t in self.slice_types.items()
                       if t in job.allowed_slice_types]
        self.alloc.register(job.name, demand=job.demand,
                            wanted_tasks=job.gang_units_wanted,
                            phi=job.priority, allowed_agents=allowed)

    def finish(self, name: str):
        self.alloc.deregister(name)
        del self.jobs[name]

    def schedule(self) -> list:
        """Run one allocation epoch -> [(job, slice, gang_units)]."""
        return [
            (g.fid, g.agent, g.n_executors)
            for g in self.alloc.allocate(batched=self.batched)
        ]

    def placement(self, name: str) -> dict:
        fw = self.alloc.frameworks[name]
        return {a: len(b) for a, b in fw.tasks.items() if b}

    def utilization(self) -> dict:
        u = self.alloc.utilization()
        return dict(zip(RESOURCES, (float(x) for x in u)))

    def snapshot(self):
        """Telemetry snapshot (repro_torch.core.online.AllocSnapshot) —
        feed it to repro_torch.core.metrics helpers (dominant_shares,
        jain_index)."""
        return self.alloc.snapshot()


def slice_agents(counts: dict) -> list:
    """{slice_type: n} -> [(name, capacity)] for the DES simulator; pair
    with :func:`repro_torch.core.workloads.gang_arrivals` to replay gang
    :class:`JobSpec` streams through ``SparkMesosSim`` under the same
    criteria/telemetry as the paper's Spark queues."""
    agents = []
    for stype, n in counts.items():
        cap = SLICE_TYPES[stype]
        agents.extend((f"{stype}-{i}", cap) for i in range(n))
    return agents
