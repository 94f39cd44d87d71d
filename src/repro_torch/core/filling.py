"""Progressive filling with integer tasking — exact reference engine.

This is the paper's Section 2 machinery: starting from the empty allocation,
repeatedly grant one task to the framework (and server) selected by the
configured fairness criterion + server-selection policy, until no task fits
anywhere ("at least one resource is exhausted in every server" up to integer
granularity).

Criterion scoring and server selection are NOT implemented here: they come
from the shared strategy modules :mod:`repro_torch.core.criteria` and
:mod:`repro_torch.core.policies`, the same objects driving the online allocator's
batched epoch engine and (for scores) the JAX fleet engine.  This file is
just the exact numpy driver: full score recompute every grant, no caching —
the oracle the fast engines are agreement-tested against.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import criteria
from repro_torch.core.instance import Instance
from repro_torch.core.policies import make_policy


@dataclasses.dataclass(frozen=True)
class FillConfig:
    criterion: str = "drf"          # drf | tsf | psdsf | rpsdsf
    server_policy: str = "rrr"      # rrr | pooled | bestfit
    lookahead: bool = True          # score x+1 (hypothetical) vs current x
    tie: str = "low"                # low | high | random  (index tie-breaks)
    bf_metric: str = "cosine"       # best-fit metric (server_policy="bestfit")
    max_steps: int = 1_000_000


@dataclasses.dataclass
class FillResult:
    x: np.ndarray            # (N, J) integer allocation
    residual: np.ndarray     # (J, R)
    steps: int
    order: list              # [(n, j), ...] grant sequence (for analysis)

    @property
    def totals(self) -> np.ndarray:
        return self.x.sum(axis=1)


def progressive_fill(
    inst: Instance,
    cfg: FillConfig,
    seed: Optional[int] = None,
    x0: Optional[np.ndarray] = None,
) -> FillResult:
    """Run progressive filling to exhaustion.  Deterministic unless the
    policy/tie-break draws randomness (then ``seed`` must be given)."""
    rng = np.random.default_rng(seed) if seed is not None else None
    D, C, phi = inst.demands, inst.capacities, inst.weights
    N, J = inst.n_frameworks, inst.n_servers
    X = np.zeros((N, J), dtype=np.int64) if x0 is None else np.array(x0, np.int64)
    order: list = []

    needs_rng = cfg.server_policy == "rrr" or cfg.tie == "random"
    if needs_rng and rng is None:
        rng = np.random.default_rng(0)

    crit = criteria.get_criterion(cfg.criterion)
    policy = make_policy(cfg.server_policy, J, rng, cfg.tie, cfg.bf_metric)

    for step in range(cfg.max_steps):
        feas = inst.feasible(X)  # (N, J) bool
        if not feas.any():
            return FillResult(X, inst.residual(X), step, order)

        scores = crit.scores(
            X, D, C, phi, lookahead=cfg.lookahead, allowed=inst.allowed,
        )
        res = inst.residual(X) if cfg.server_policy == "bestfit" else None
        n, j = policy.select(
            scores, feas, server_specific=crit.server_specific,
            demands=D, residual=res,
        )
        X[n, j] += 1
        order.append((n, j))

    raise RuntimeError("progressive_fill did not terminate within max_steps")


def run_trials(
    inst: Instance, cfg: FillConfig, n_trials: int, seed: int = 0
) -> np.ndarray:
    """(n_trials, N, J) allocations over independent randomized trials."""
    out = np.zeros((n_trials, inst.n_frameworks, inst.n_servers), np.int64)
    for t in range(n_trials):
        out[t] = progressive_fill(inst, cfg, seed=seed + t).x
    return out


# -- The paper's named schedulers (Section 2, Table 1 rows) -----------------
# Knobs calibrated against the paper's Tables 1-4 (see EXPERIMENTS.md §Paper):
#   * lookahead=False everywhere — the paper's criteria are written on the
#     CURRENT allocation (K~ = x_n * max_r ...), and only this setting
#     reproduces both the PS-DSF pooled row exactly and the RRR-PS-DSF
#     variance structure (ties at x=0 are what make RRR-PS-DSF stochastic).
#   * PS-DSF pooled, tie=low  -> (19,0,2,20), exact Table-1 match.
#   * rPS-DSF pooled          -> (19,2,2,19), exact match (robust to all knobs);
#     RRR-rPS-DSF == rPS-DSF over 200 trials, reproducing the paper's claim.
#   * BF-DRF: (19,2,2,19) total 42 vs the paper's (20,2,0,19) total 41. The
#     paper's exact vector is PROVABLY unreachable under one-task-at-a-time
#     DRF alternation (see EXPERIMENTS.md §Paper for the argument); their
#     Mesos patch granted coarser offers. Qualitative claim (BF-DRF ~ 41-42
#     >> DRF ~ 22.4) reproduces.

PAPER_SCHEDULERS = {
    "DRF": FillConfig(criterion="drf", server_policy="rrr", tie="random", lookahead=False),
    "TSF": FillConfig(criterion="tsf", server_policy="rrr", tie="random", lookahead=False),
    "RRR-PS-DSF": FillConfig(criterion="psdsf", server_policy="rrr", tie="random", lookahead=False),
    "BF-DRF": FillConfig(criterion="drf", server_policy="bestfit", bf_metric="cosine", tie="low", lookahead=False),
    "PS-DSF": FillConfig(criterion="psdsf", server_policy="pooled", tie="low", lookahead=False),
    "rPS-DSF": FillConfig(criterion="rpsdsf", server_policy="pooled", tie="low", lookahead=False),
    "RRR-rPS-DSF": FillConfig(criterion="rpsdsf", server_policy="rrr", tie="random", lookahead=False),
}
