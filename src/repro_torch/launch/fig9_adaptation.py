"""Reproduces Figure 9: BF-DRF stays stuck in a suboptimal allocation while
rPS-DSF adapts (Section 3.7).

The paper's construction: three servers (one per type) registered one-by-one
lead to the initial allocation
    type-1 (4,14): 1 Pi + 2 WC     (CPU exhausted, 5 GB stranded)
    type-2 (8,8):  2 Pi + 1 WC     (memory fragmented, 3 CPUs stranded)
    type-3 (6,11): 2 Pi + 2 WC     (perfectly packed)
Whenever a framework releases an executor, its fairness score drops, so a
DRF-based allocator re-offers the freed resources to the SAME framework
(which best-fit cannot fix: only the freed server has room) — the placement
is locked in.  rPS-DSF scores against the freed server's residual shape, so
the *aligned* group wins the hole and efficiency climbs.

Optimal packing: type-1 = 4 WC, type-2 = 4 Pi, type-3 = 2+2 -> memory 33/33.

Emits CSV: scheduler,iteration,mem_efficiency

The allocator runs on the card (``--device cuda``, the default) unless asked
for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.fig9_adaptation --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.online import OnlineAllocator

PI_D = (2.0, 2.0)
WC_D = (1.0, 3.5)
SERVERS = {"type1": (4.0, 14.0), "type2": (8.0, 8.0), "type3": (6.0, 11.0)}
INITIAL = {  # (fid, agent) -> executors
    ("Pi", "type1"): 1, ("WordCount", "type1"): 2,
    ("Pi", "type2"): 2, ("WordCount", "type2"): 1,
    ("Pi", "type3"): 2, ("WordCount", "type3"): 2,
}

SCHEDULERS = {
    "BF-DRF": dict(criterion="drf", server_policy="bestfit"),
    "DRF": dict(criterion="drf", server_policy="rrr"),
    "PS-DSF": dict(criterion="psdsf", server_policy="rrr"),
    "rPS-DSF": dict(criterion="rpsdsf", server_policy="rrr"),
}


def _make(scheduler: str, seed: int, device="cuda") -> OnlineAllocator:
    al = OnlineAllocator(2, mode="characterized", seed=seed, device=device,
                         **SCHEDULERS[scheduler])
    for name, cap in SERVERS.items():
        al.add_agent(name, cap)
    al.register("Pi", demand=PI_D, wanted_tasks=16)
    al.register("WordCount", demand=WC_D, wanted_tasks=16)
    for (fid, agent), n in INITIAL.items():
        al.force_place(fid, agent, n)
    return al


def _mem_eff(al: OnlineAllocator) -> float:
    return float(al.utilization()[1])


def run_one(scheduler: str, iters: int = 60, seed: int = 0, device="cuda"):
    al = _make(scheduler, seed, device)
    rng = np.random.default_rng(seed)
    trace = [_mem_eff(al)]
    for _ in range(iters):
        # a random occupied (framework, agent) executor finishes & releases
        occupied = [
            (f, a)
            for f, fw in al.frameworks.items()
            for a, bundles in fw.tasks.items()
            if bundles
        ]
        f, a = occupied[rng.integers(len(occupied))]
        al.release_executor(f, a)
        al.allocate()
        trace.append(_mem_eff(al))
    return np.array(trace)


def run(print_csv: bool = True, device="cuda"):
    traces = {s: np.mean([run_one(s, seed=k, device=device)
                          for k in range(10)], axis=0)
              for s in SCHEDULERS}
    if print_csv:
        print("scheduler,iteration,mem_efficiency")
        for s, tr in traces.items():
            for i, v in enumerate(tr):
                print(f"{s},{i},{v:.4f}")
        final = {s: tr[-10:].mean() for s, tr in traces.items()}
        print(f"# final-10-iteration mean memory efficiency: "
              + ", ".join(f"{s}={v:.3f}" for s, v in final.items()))
        ok1 = final["rPS-DSF"] > final["BF-DRF"] + 0.05
        ok2 = final["rPS-DSF"] > 0.93
        print(f"# CLAIM {'PASS' if ok1 else 'FAIL'}: rPS-DSF adapts, BF-DRF does not")
        print(f"# CLAIM {'PASS' if ok2 else 'FAIL'}: rPS-DSF approaches optimal packing")
    return traces


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the allocator (cuda or cpu)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
