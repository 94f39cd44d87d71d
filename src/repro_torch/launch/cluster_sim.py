"""Fleet-level demo: the paper's fair allocators gang-scheduling the assigned
architectures onto a heterogeneous TPU-slice fleet, with failures.

    PYTHONPATH=src python -m repro_torch.launch.cluster_sim --criterion rpsdsf
    PYTHONPATH=src python -m repro_torch.launch.cluster_sim --des  # DES replay

``--des`` replays the same gang jobs as an arrival stream through the
discrete-event simulator (repro_torch.core.workloads.gang_arrivals) with
fairness-over-time hooks — the paper's telemetry on accelerator-shaped
resources.  Both run the port's allocator on the card (``--device cuda``,
the default) unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from repro_torch.cluster.gang import (
    GangScheduler, JobSpec, SLICE_TYPES, demand_from_dryrun, slice_agents,
)
from repro_torch.core import metrics
from repro_torch.core.workloads import gang_arrivals


def default_jobs(dryrun_dir: str = "artifacts/dryrun"):
    """One job per assigned arch, demands characterized from dry-run cells
    when available (else a static fallback catalog)."""
    fallback = {
        # (chips, hbm_gib, host_ram_gib, ici_gbps) per 16-chip gang unit
        "gemma3_12b": (16.0, 160.0, 32.0, 300.0),
        "qwen3_8b": (16.0, 120.0, 32.0, 220.0),
        "mistral_nemo_12b": (16.0, 170.0, 32.0, 310.0),
        "qwen2_1_5b": (16.0, 70.0, 32.0, 50.0),
        "whisper_large_v3": (16.0, 110.0, 32.0, 70.0),
        "rwkv6_3b": (16.0, 60.0, 32.0, 140.0),
        "llama32_vision_90b": (16.0, 400.0, 32.0, 900.0),
        "deepseek_v2_236b": (16.0, 480.0, 32.0, 1300.0),
        "granite_moe_3b": (16.0, 100.0, 32.0, 800.0),
        "hymba_1_5b": (16.0, 80.0, 32.0, 60.0),
    }
    jobs = []
    for arch, dem in fallback.items():
        art = os.path.join(dryrun_dir, f"{arch}__train_4k__single.json")
        if os.path.exists(art):
            dem = demand_from_dryrun(art)
        jobs.append(JobSpec(name=f"train-{arch}", arch=arch, shape="train_4k",
                            gang_units_wanted=8, demand=dem))
    return jobs


def run(criterion: str, seed: int = 0, n_epochs: int = 6, verbose: bool = True,
        batched: bool = False, device="cuda"):
    gs = GangScheduler(criterion=criterion, seed=seed, batched=batched,
                       device=device)
    rng = np.random.default_rng(seed)
    for i in range(6):
        gs.add_slice(f"fat{i}", "v5e-64-fat-host")
    for i in range(6):
        gs.add_slice(f"std{i}", "v5e-64")
    for i in range(4):
        gs.add_slice(f"ici{i}", "v5e-32-highici")

    jobs = default_jobs()
    for j in jobs:
        gs.submit(j)

    log = []
    for epoch in range(n_epochs):
        grants = gs.schedule()
        util = gs.utilization()
        snap = gs.snapshot()
        jain = metrics.jain_index(
            metrics.dominant_shares(snap.usage, snap.cap_total, snap.phi)
        )
        log.append({**util, "jain": jain})
        if verbose:
            print(f"epoch {epoch}: +{len(grants)} grants, jain={jain:.3f}, util "
                  + " ".join(f"{k}={v:.2f}" for k, v in util.items()))
        # churn: a slice fails, a job completes, a new job arrives
        if epoch == 2:
            lost = gs.fail_slice("std0")
            if verbose:
                print(f"  [fault] slice std0 failed; lost {lost}")
        if epoch == 3:
            gs.finish(jobs[0].name)
            if verbose:
                print(f"  [churn] {jobs[0].name} completed")
    return log


def run_des(criterion: str, seed: int = 0, verbose: bool = True,
            batched: bool = True, device="cuda"):
    """Event-driven replay: the same gang jobs as a timed arrival stream
    through the DES, with fairness-over-time telemetry."""
    from repro_torch.core.simulator import SimConfig, SparkMesosSim

    agents = slice_agents({"v5e-64-fat-host": 6, "v5e-64": 6,
                           "v5e-32-highici": 4})
    src = gang_arrivals(default_jobs(), arrival_gap_s=20.0,
                        mean_task_s=120.0, tasks_per_unit=4)
    fair, slow = metrics.FairnessTimelineHook(), metrics.SlowdownHook()
    cfg = SimConfig(criterion=criterion, mode="characterized", seed=seed,
                    batched=batched, alloc_interval=2.0, device=device)
    r = SparkMesosSim(agents, src, cfg, hooks=[fair, slow]).run()
    f = fair.summary()
    if verbose:
        print(f"  makespan {r.makespan:7.1f}s  chips-used {r.mean_used(0):.2f}  "
              f"jain-tw {f['jain_tw_mean']:.3f}  jain-min {f['jain_min']:.3f}")
    return r, f, slow.summary()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--criterion", default="rpsdsf",
                    choices=["drf", "tsf", "psdsf", "rpsdsf"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batched", action="store_true",
                    help="use the incremental batched epoch engine")
    ap.add_argument("--des", action="store_true",
                    help="event-driven gang-arrival replay with fairness "
                         "telemetry (batched engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the allocator (cuda or cpu)")
    args = ap.parse_args()
    if args.des:
        print("== DES replay: gang-job arrival stream, fairness over time ==")
        for crit in ["drf", "psdsf", "rpsdsf"]:
            print(f"[{crit}]")
            run_des(crit, args.seed, device=args.device)
        return
    print(f"== fleet gang-scheduling with {args.criterion} ==")
    run(args.criterion, args.seed, batched=args.batched, device=args.device)
    print("== comparison: chip utilization + fairness after warm-up ==")
    for crit in ["drf", "psdsf", "rpsdsf"]:
        log = run(crit, args.seed, verbose=False, batched=args.batched,
                  device=args.device)
        print(f"{crit:8s} chips={log[-1]['chips']:.3f} hbm={log[-1]['hbm_gib']:.3f} "
              f"ici={log[-1]['ici_gbps']:.3f} jain={log[-1]['jain']:.3f}")


if __name__ == "__main__":
    main()
