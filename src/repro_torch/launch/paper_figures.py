"""Reproduces the paper's Figures 3-8 (Section 3 Mesos/Spark experiments).

Runs the discrete-event Spark-on-Mesos simulator over the experiment matrix
(criterion x information mode, heterogeneous + homogeneous clusters) with a
fairness-over-time hook attached, and emits CSV:
figure,config,makespan,used_cpu,used_mem,used_cpu_std,alloc_cpu,jain_tw

Claims validated (qualitatively, as in the paper):
  Fig 3/4: PS-DSF >= DRF utilization, earlier batch completion (heterogeneous)
  Fig 5:   TSF ~ DRF; BF-DRF / rPS-DSF ~ PS-DSF
  Fig 6/7: characterized beats oblivious; oblivious has higher used-variance
  Fig 8:   DRF == PS-DSF on a homogeneous cluster

The simulator's allocator runs on the card (``--device cuda``, the default)
unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.paper_figures --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.metrics import FairnessTimelineHook
from repro_torch.core.simulator import (
    HETEROGENEOUS_AGENTS,
    HOMOGENEOUS_AGENTS,
    run_paper_experiment,
)

SEEDS = range(8)
JOBS_PER_QUEUE = 10


def _avg(crit, mode, agents=None, server_policy="rrr", device="cuda"):
    out = []
    for s in SEEDS:
        fair = FairnessTimelineHook()
        r = run_paper_experiment(
            crit, mode, agents=agents, server_policy=server_policy,
            jobs_per_queue=JOBS_PER_QUEUE, seed=s, hooks=[fair],
            device=device,
        )
        out.append(
            (r.makespan, r.mean_used(0), r.mean_used(1), r.used_std(0),
             r.mean_util(0), fair.summary()["jain_tw_mean"])
        )
    return np.mean(out, axis=0)


def run(print_csv: bool = True, device="cuda"):
    grid = {
        # fig3: oblivious DRF vs PS-DSF;  fig4: characterized DRF vs PS-DSF
        "fig3_obliv_DRF": ("drf", "oblivious", None, "rrr"),
        "fig3_obliv_PS-DSF": ("psdsf", "oblivious", None, "rrr"),
        "fig4_char_DRF": ("drf", "characterized", None, "rrr"),
        "fig4_char_PS-DSF": ("psdsf", "characterized", None, "rrr"),
        # fig5: TSF vs BF-DRF vs rPS-DSF (characterized)
        "fig5_char_TSF": ("tsf", "characterized", None, "rrr"),
        "fig5_char_BF-DRF": ("drf", "characterized", None, "bestfit"),
        "fig5_char_rPS-DSF": ("rpsdsf", "characterized", None, "rrr"),
        # fig8: homogeneous cluster
        "fig8_homog_DRF": ("drf", "characterized", HOMOGENEOUS_AGENTS, "rrr"),
        "fig8_homog_PS-DSF": ("psdsf", "characterized", HOMOGENEOUS_AGENTS, "rrr"),
    }
    rows = {}
    for name, (crit, mode, agents, pol) in grid.items():
        rows[name] = _avg(crit, mode, agents, pol, device)

    if print_csv:
        print("figure_config,makespan,used_cpu,used_mem,used_cpu_std,alloc_cpu,jain_tw")
        for name, (m, c, me, sv, ac, jn) in rows.items():
            print(f"{name},{m:.1f},{c:.3f},{me:.3f},{sv:.3f},{ac:.3f},{jn:.3f}")
        checks = [
            ("fig3/4: char PS-DSF <= char DRF makespan",
             rows["fig4_char_PS-DSF"][0] <= rows["fig4_char_DRF"][0] * 1.02),
            ("fig4: PS-DSF used_cpu >= DRF",
             rows["fig4_char_PS-DSF"][1] >= rows["fig4_char_DRF"][1] - 0.01),
            ("fig5: TSF ~ DRF (within 5%)",
             abs(rows["fig5_char_TSF"][0] - rows["fig4_char_DRF"][0])
             < 0.05 * rows["fig4_char_DRF"][0]),
            ("fig6/7: characterized beats oblivious (DRF)",
             rows["fig4_char_DRF"][0] < rows["fig3_obliv_DRF"][0]),
            ("fig6/7: oblivious used-variance higher (DRF)",
             rows["fig3_obliv_DRF"][3] > rows["fig4_char_DRF"][3]),
            ("fig6/7: characterized utilizes more (DRF)",
             rows["fig4_char_DRF"][1] > rows["fig3_obliv_DRF"][1]),
            ("fig8: homogeneous DRF == PS-DSF (within 2%)",
             abs(rows["fig8_homog_DRF"][0] - rows["fig8_homog_PS-DSF"][0])
             < 0.02 * rows["fig8_homog_DRF"][0]),
        ]
        for desc, ok in checks:
            print(f"# CLAIM {'PASS' if ok else 'FAIL'}: {desc}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the allocator (cuda or cpu)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
