"""Pluggable server-selection policies + tie-break helpers (numpy engines).

One implementation each of the paper's three server-selection disciplines,
shared by the exact reference filler (:mod:`repro.core.filling`) and the
batched online epoch engine (:mod:`repro.core.engine`) — the two consume the
same RNG stream through the same code, which is what makes their grant
sequences bit-for-bit comparable in the parity suite.

  * ``rrr``     Randomized Round-Robin (Mesos default): servers take turns in
                a random order, re-permuted each round; the visited server
                picks the feasible framework with minimum criterion score.
  * ``pooled``  All feasible (framework, server) pairs compete jointly.  For
                server-specific criteria (PS-DSF / rPS-DSF) the pair with the
                minimum K_{n,j} wins; for global criteria the framework with
                the minimum score wins and the server is chosen by tie-break.
  * ``bestfit`` The framework is chosen first by the criterion; the server is
                then chosen by a best-fit metric over residual capacities
                (this is BF-DRF when criterion="drf").

Policies are *stateful per fill/epoch* (RRR carries its round permutation),
so construct a fresh one via :func:`make_policy` for every run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import criteria


def tiebreak(idxs: np.ndarray, tie: str, rng: Optional[np.random.Generator]):
    if len(idxs) == 1:
        return int(idxs[0])
    if tie == "low":
        return int(idxs[0])
    if tie == "high":
        return int(idxs[-1])
    if tie == "random":
        assert rng is not None, "random tie-break needs an rng"
        return int(rng.choice(idxs))
    raise ValueError(f"unknown tie rule {tie!r}")


def argmin_masked(scores: np.ndarray, mask: np.ndarray, tie: str, rng) -> Optional[int]:
    """Index of the min score among mask=True entries (flat), or None."""
    if not mask.any():
        return None
    s = np.where(mask, scores, np.inf)
    m = s.min()
    idxs = np.flatnonzero(np.isclose(s, m, rtol=0, atol=1e-12))
    return tiebreak(idxs, tie, rng)


class ServerPolicy:
    """Strategy: pick the next (framework, server) grant.

    ``scores`` is (N,) for global criteria, (N, J) for server-specific ones
    (flagged by ``server_specific``); ``feas`` is the (N, J) feasibility
    mask, guaranteed non-empty by the caller.  ``demands``/``residual`` are
    only consulted by best-fit."""

    name: str = "?"

    def select(self, scores, feas, *, server_specific: bool,
               demands=None, residual=None) -> tuple[int, int]:
        raise NotImplementedError


class RRRPolicy(ServerPolicy):
    """Randomized round-robin over servers; skips servers where nothing fits.

    Visits up to 2*J servers per grant: the remainder of the current round
    plus one full fresh round is guaranteed to reach a feasible server
    (re-permuting mid-round can revisit servers, so J alone is not)."""

    name = "rrr"

    def __init__(self, n_servers: int, rng: np.random.Generator, tie: str = "low"):
        assert rng is not None, "RRR needs an rng"
        self.J = n_servers
        self.rng = rng
        self.tie = tie
        self.perm = rng.permutation(n_servers)
        self.pos = 0

    def select(self, scores, feas, *, server_specific, demands=None, residual=None):
        for _ in range(2 * self.J):
            j = int(self.perm[self.pos])
            self.pos += 1
            if self.pos == self.J:
                self.perm = self.rng.permutation(self.J)
                self.pos = 0
            col = feas[:, j]
            if not col.any():
                continue
            s = scores[:, j] if server_specific else scores
            n = argmin_masked(s, col, self.tie, self.rng)
            return n, j
        raise AssertionError("RRR failed to reach a feasible server")


class PooledPolicy(ServerPolicy):
    name = "pooled"

    def __init__(self, n_servers: int, rng, tie: str = "low"):
        self.rng = rng
        self.tie = tie

    def select(self, scores, feas, *, server_specific, demands=None, residual=None):
        J = feas.shape[1]
        if server_specific:
            flat = argmin_masked(scores.ravel(), feas.ravel(), self.tie, self.rng)
            return divmod(flat, J)
        n = argmin_masked(scores, feas.any(axis=1), self.tie, self.rng)
        j = tiebreak(np.flatnonzero(feas[n]), self.tie, self.rng)
        return n, j


class BestFitPolicy(ServerPolicy):
    name = "bestfit"

    def __init__(self, n_servers: int, rng, tie: str = "low", metric: str = "cosine"):
        self.rng = rng
        self.tie = tie
        self.metric = metric

    def select(self, scores, feas, *, server_specific, demands=None, residual=None):
        if server_specific:
            # best-fit after a server-specific criterion: pick the framework
            # by its best (min over feasible servers) score.
            per_fw = np.where(feas, scores, np.inf).min(axis=1)
            n = argmin_masked(per_fw, feas.any(axis=1), self.tie, self.rng)
        else:
            n = argmin_masked(scores, feas.any(axis=1), self.tie, self.rng)
        bf = criteria.bestfit_scores(residual, demands[n], metric=self.metric)
        j = argmin_masked(bf, feas[n], self.tie, self.rng)
        return n, j


POLICIES = ("rrr", "pooled", "bestfit")
_CLASSES = {"rrr": RRRPolicy, "pooled": PooledPolicy, "bestfit": BestFitPolicy}


def make_policy(name: str, n_servers: int, rng, tie: str = "low",
                bf_metric: str = "cosine") -> ServerPolicy:
    if name == "bestfit":
        return BestFitPolicy(n_servers, rng, tie, bf_metric)
    try:
        return _CLASSES[name](n_servers, rng, tie)
    except KeyError:
        raise ValueError(f"unknown server policy {name!r}") from None
