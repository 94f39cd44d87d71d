"""Reproduces the paper's Tables 1-4 (Section 2 illustrative example).

Emits CSV rows: table,scheduler,cell,value,paper_value — plus a
T5_jain_dominant_share row per scheduler: Jain's fairness index over the
frameworks' dominant shares at the final allocation (repro_torch.core.metrics),
quantifying the fairness/packing trade-off the tables only imply.

The fills run on the card (``--device cuda``, the default) unless asked
for the CPU, through :mod:`repro_torch.core.filling_torch`: the pooled
PS-DSF and rPS-DSF fills on the persistent epoch kernel, the others on the
step loop.  The deterministic rows equal the exact numpy filler's; the
stochastic ones are statistics of 200 trials drawn from torch generators:

    PYTHONPATH=src python -m repro_torch.launch.paper_tables --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.engine_torch import resolve_device
from repro_torch.core.filling import PAPER_SCHEDULERS
from repro_torch.core.filling_torch import fill_trials_torch, progressive_fill_torch
from repro_torch.core.instance import paper_example
from repro_torch.core.metrics import dominant_shares, jain_index

N_TRIALS = 200

# Paper values: Table 1 (allocations x_{n,i}), Table 2 (std of x under RRR),
# Table 3 (unused capacities), Table 4 (std of unused under RRR).
PAPER_T1 = {
    "DRF": [6.55, 4.69, 4.69, 6.55],
    "TSF": [6.5, 4.7, 4.7, 6.5],
    "RRR-PS-DSF": [19.44, 1.15, 1.07, 19.42],
    "BF-DRF": [20, 2, 0, 19],
    "PS-DSF": [19, 0, 2, 20],
    "rPS-DSF": [19, 2, 2, 19],
}
PAPER_T2 = {
    "DRF": [2.31, 0.46, 0.46, 2.31],
    "TSF": [2.29, 0.46, 0.46, 2.29],
    "RRR-PS-DSF": [0.59, 0.99, 1.0, 0.49],
}
PAPER_T3 = {
    "DRF": [62.56, 0, 0, 62.56],
    "TSF": [62.8, 0, 0, 62.8],
    "RRR-PS-DSF": [1.8, 4.6, 4.86, 1.92],
    "BF-DRF": [0, 10, 1, 3],
    "PS-DSF": [3, 1, 10, 0],
    "rPS-DSF": [3, 1, 1, 3],
}

STOCHASTIC = ("DRF", "TSF", "RRR-PS-DSF")
DETERMINISTIC = ("BF-DRF", "PS-DSF", "rPS-DSF")


def fills(inst, device):
    """-> ({name: (T, N, J)} trials of the stochastic schedulers,
    {name: (N, J)} fills of the deterministic ones), as numpy int32."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=device)
    args = (t(inst.demands), t(inst.capacities), t(inst.weights))

    def kw(name):
        cfg = PAPER_SCHEDULERS[name]
        return dict(criterion=cfg.criterion, policy=cfg.server_policy,
                    lookahead=cfg.lookahead, tie=cfg.tie)

    gen = torch.Generator(device=device)
    trials = {name: fill_trials_torch(*args, N_TRIALS,
                                      generator=gen.manual_seed(1),
                                      **kw(name)).cpu().numpy()
              for name in STOCHASTIC}
    once = {name: progressive_fill_torch(*args, None,
                                         **kw(name)).cpu().numpy()
            for name in DETERMINISTIC}
    return trials, once


def table_rows(inst, trials, once):
    """-> the CSV rows (table, scheduler, cell, value, paper_value) of the
    two dicts :func:`fills` returns."""
    rows = []

    def emit(table, sched, cells, paper):
        for i, (v, p) in enumerate(zip(np.ravel(cells), np.ravel(paper))):
            rows.append((table, sched, i, float(v), float(p)))

    def jain_of(x_alloc):
        # x_alloc (N,) total tasks -> (N, R) held resources -> dominant shares
        usage = np.asarray(x_alloc)[:, None] * inst.demands
        s = dominant_shares(usage, inst.capacities.sum(axis=0), inst.weights)
        return jain_index(s)

    for name in STOCHASTIC:
        x = trials[name]
        res = np.array([inst.residual(xi) for xi in x])
        emit("T1_alloc_mean", name, x.mean(0), PAPER_T1[name])
        emit("T2_alloc_std", name, x.std(0, ddof=1), PAPER_T2[name])
        emit("T3_unused_mean", name, res.mean(0), PAPER_T3[name])
        rows.append(("T5_jain_dominant_share", name, 0,
                     float(np.mean([jain_of(xi.sum(axis=1)) for xi in x])), 1.0))

    for name in DETERMINISTIC:
        x = once[name]
        emit("T1_alloc_mean", name, x, PAPER_T1[name])
        emit("T3_unused_mean", name, inst.residual(x), PAPER_T3[name])
        rows.append(("T5_jain_dominant_share", name, 0,
                     jain_of(np.asarray(x, np.float64).sum(axis=1)), 1.0))
    return rows


def run(print_csv: bool = True, device="cuda"):
    inst = paper_example()
    rows = table_rows(inst, *fills(inst, resolve_device(device)))

    if print_csv:
        print("table,scheduler,cell,value,paper_value")
        for t, s, i, v, p in rows:
            print(f"{t},{s},{i},{v:.3f},{p:.3f}")
        # headline: totals
        print("# headline totals (paper: DRF 22.48, TSF 22.4, RRR-PS-DSF 41.08,"
              " BF-DRF 41, PS-DSF 41, rPS-DSF 42)")
        for name in PAPER_T1:
            tot = sum(v for t, s, i, v, p in rows if t == "T1_alloc_mean" and s == name)
            print(f"# total,{name},{tot:.2f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fills (cuda or cpu)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
