"""Batched allocation epoch: score once, grant many.

The per-grant (legacy-compatible) online path recomputes feasibility and
criterion scores from scratch before every grant — O(N*J*R) per grant.  A
:class:`BatchedEpoch` freezes the cluster membership at epoch start, computes
the expensive X-independent parts ONCE (DRF dominant fractions, TSF monopoly
terms, PS-DSF dominant-share matrices), and then keeps scores + feasibility
consistent with O((N+J)*R) incremental updates per grant:

  * a grant to (n, j) changes x_n  -> refresh score row n;
  * it consumes FREE[j]            -> refresh feasibility column j;
  * under rPS-DSF it also changes server j's residual -> refresh the
    dominant-share COLUMN j only (the other servers' residuals are
    untouched);
  * in oblivious mode an inferred-demand change triggers the (rare) full
    refresh.

Every refresh applies the same elementwise formulas from
:mod:`repro.core.criteria` that the full recompute would, so the grant
sequence is identical to the exact reference filler's when driven by the
same :mod:`repro.core.policies` object and RNG stream (verified by the
parity suite for the paper's binary-exact demand vectors).

Preemption ordering: with revocable offers enabled the epoch-level
preemption pass (:mod:`repro.core.preemption`) runs — on the host, rng-free
— BEFORE this engine is constructed, so a ``BatchedEpoch`` always scores
the post-revocation state; the grant loop itself never revokes.  The
revocable/firm split of each resulting grant is classified downstream in
``OnlineAllocator._grant`` (shared by every engine path), so this engine
needs no preemption-specific state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import criteria
from repro_torch.core.policies import make_policy

_KBIG = 3.0e38  # unsatisfiable-demand sentinel for the kernel backend
                # (matches repro.kernels.psdsf_score BIG up to headroom)

#: Measured crossover for ``use_kernel="auto"`` path selection, in epoch
#: cells (N frameworks x J agents).  The candidates are the legacy per-grant
#: recompute, this numpy incremental epoch, and the fused device epoch
#: (:mod:`repro.core.engine_jax`); per BENCH_allocator.json the per-grant
#: path never wins (batched is 18-52x faster at every benched size), so the
#: auto rule reduces to batched-vs-device.  Below ``AUTO_KERNEL_FLOOR_CELLS``
#: the resolver returns the numpy epoch without even importing jax.  On the
#: CPU backend the numpy epoch beats the device epoch at BOTH benched sizes
#: (50x25: ~21.6k vs ~10.2k grants/s; 200x100: ~18.5k vs ~11.9k for
#: drf/rrr), so its crossover sits past the 1000x400 ``--big`` point, at
#: fleet scale where the O(N*J) argmin-per-grant select dominates the numpy
#: epoch; accelerator backends flip far earlier (dispatch overhead is fixed
#: while the numpy host loop is not).
#: Keyed by torch device type.  The "cuda" entry starts from the reference's
#: non-CPU value; it has not been measured on the card yet.
AUTO_KERNEL_MIN_CELLS = {"cpu": 1 << 19, "cuda": 1 << 13}
#: below the smallest per-backend threshold the resolver's answer is
#: "numpy" on every backend, so it never needs to import jax to know it
AUTO_KERNEL_FLOOR_CELLS = min(AUTO_KERNEL_MIN_CELLS.values())
#: Floors for the PARTITIONED fused dispatches under ``use_kernel="auto"``:
#: a requested shard count / device-mesh size is honored only at or above
#: these epoch-cell sizes and silently collapses to the plain fused path
#: below them.  Both partitionings pay a fixed per-grant toll — the sharded
#: select a two-pass tile reduce, the mesh a cross-device collective
#: rendezvous — that the measured crossovers (BENCH_allocator.json) only
#: amortize near fleet scale: sharded selects lose below the ~2000x1000
#: point (1.14x at it) and the mesh's per-grant collectives dwarf the
#: O(N + J/devices) body at toy sizes while winning 1.5x+ at the fleet
#: point.  Explicit ``shards=``/``devices=`` requests are never clamped.
AUTO_SHARD_MIN_CELLS = 1 << 20
AUTO_MESH_MIN_CELLS = 1 << 20

def _kernel_backend():
    raise NotImplementedError(
        "use_kernel='pergrant' needs the fused psdsf_argmin kernel, which "
        "is not ported yet (queued); use use_kernel='fused' or False")


class BatchedEpoch:
    """Incremental scorer + selector for one allocation epoch.

    Parameters
    ----------
    criterion : criteria.Criterion (or name)
    policy    : server policy name ("rrr" | "pooled" | "bestfit")
    true_demands : (N, R) per-executor demands used for feasibility and
        best-fit (the oracle demands; rows of non-wanting frameworks may be
        zero, they are masked out via ``wanted``).
    D : (N, R) scoring demands (== true_demands when characterized; the
        allocator's *inferred* demands when oblivious).
    usage : (N, R) aggregate held resources — only consulted for the
        oblivious DRF/TSF usage-share surrogate.
    use_kernel : opt in to the PER-GRANT Pallas ``psdsf_score``
        scoring/argmin backend: one kernel launch + scalar readback per
        pick, against device-resident mirrors of the kernel inputs that are
        uploaded once per epoch and updated incrementally per grant.
        Engaged only when it matches the numpy semantics: characterized
        rPS-DSF + pooled policy + tie="low" + no placement constraints
        (otherwise the numpy incremental path runs).  Tie-breaking across
        128-wide tiles may differ from the numpy path when scores are
        exactly equal.  For the fully fused alternative (whole epoch in one
        dispatch, wider criterion/policy coverage) see
        :mod:`repro.core.engine_jax` via
        ``OnlineAllocator.allocate_batched(use_kernel=True)``.
    """

    def __init__(self, criterion, policy: str, *, X, D, C, FREE, phi, allowed,
                 wanted, true_demands, mode: str = "characterized",
                 lookahead: bool = False, tie: str = "low",
                 rng: Optional[np.random.Generator] = None,
                 bf_metric: str = "cosine",
                 per_agent_limit: Optional[int] = None,
                 usage: Optional[np.ndarray] = None,
                 tsf_use_allowed: bool = True,
                 use_kernel: bool = False):
        self.crit = criteria.get_criterion(criterion)
        self.mode = mode
        self.lookahead = lookahead
        N, J = X.shape
        self.X = np.array(X, np.float64)
        self.D = np.array(D, np.float64)
        self.C = np.asarray(C, np.float64)
        self.FREE = np.array(FREE, np.float64)
        self.phi = np.asarray(phi, np.float64)
        self.allowed = np.asarray(allowed, bool)
        self.wanted = np.asarray(wanted, np.float64)
        self.TD = np.asarray(true_demands, np.float64)
        self.usage = None if usage is None else np.array(usage, np.float64)
        self.tot = self.X.sum(axis=1)
        self.limit = per_agent_limit
        self.used = np.zeros(J, np.int64)
        self.tsf_allowed = self.allowed if tsf_use_allowed else None
        self.kernel = bool(
            use_kernel
            and self.crit.name == "rpsdsf" and policy == "pooled"
            and mode == "characterized" and tie == "low"
            and not lookahead
            and self.allowed.all()
        )
        if self.kernel:
            self.cap = criteria.residual_capacities(self.X, self.D, self.C)
            self._kd = np.where((self.tot < self.wanted)[:, None],
                                self.D, _KBIG)
            self._kres = self.cap.copy()
            # device-resident mirrors of the kernel inputs: uploaded ONCE per
            # epoch and updated in O(1)/O(R) per grant, so the per-grant path
            # stops re-uploading O(N*R + J*R) floats on every pick.
            _, jnp = _kernel_backend()
            self._dev_tot = jnp.asarray(self.tot, jnp.float32)
            self._dev_phi = jnp.asarray(self.phi, jnp.float32)
            self._dev_kd = jnp.asarray(self._kd, jnp.float32)
            self._dev_kres = jnp.asarray(self._kres, jnp.float32)
            self.policy = None
            return
        self.policy = make_policy(policy, J, rng, tie, bf_metric)
        self._init_scores()
        self.feas = criteria.feasible_mask(
            self.TD, self.FREE, self.allowed, self.tot < self.wanted)

    # -- scoring --------------------------------------------------------------

    def _xt(self):
        return self.tot + (1.0 if self.lookahead else 0.0)

    def _init_scores(self):
        name = self.crit.name
        if self.mode == "oblivious" and name in ("drf", "tsf"):
            self.kind = "usage"
            self.s = criteria.usage_dominant_share(self.usage, self.C, self.phi)
        elif name == "drf":
            self.kind = "drf"
            self.unit = criteria.drf_dominant(self.D, self.C)
            self.s = self._xt() * self.unit / self.phi
        elif name == "tsf":
            self.kind = "tsf"
            monopoly = criteria.tsf_monopoly(self.D, self.C, allowed=self.tsf_allowed)
            self.denom = self.phi * np.maximum(monopoly, 1e-30)
            self.s = self._xt() / self.denom
        else:  # psdsf / rpsdsf
            self.kind = self.crit.name
            if self.kind == "rpsdsf":
                self.cap = criteria.residual_capacities(self.X, self.D, self.C)
            else:
                self.cap = self.C
            self.dom = criteria.virtual_dominant(self.D, self.cap)
            self.s = (self._xt() / self.phi)[:, None] * self.dom

    def _refresh_scores(self, n: int, j: int, demand_changed: bool):
        if demand_changed:
            # oblivious inferred-demand drift: recompute from scratch (rare,
            # and only reachable for psdsf/rpsdsf scoring in oblivious mode).
            self._init_scores()
            return
        if self.kind == "usage":
            self.s[n] = criteria.usage_dominant_share(
                self.usage[n:n + 1], self.C, self.phi[n:n + 1])[0]
        elif self.kind == "drf":
            xt_n = self.tot[n] + (1.0 if self.lookahead else 0.0)
            self.s[n] = xt_n * self.unit[n] / self.phi[n]
        elif self.kind == "tsf":
            xt_n = self.tot[n] + (1.0 if self.lookahead else 0.0)
            self.s[n] = xt_n / self.denom[n]
        else:
            xt = self._xt()
            if self.kind == "rpsdsf":
                # only server j's residual changed: refresh that column
                self.cap[j] = self.C[j] - self.X[:, j] @ self.D
                self.dom[:, j] = criteria.virtual_dominant(
                    self.D, self.cap[j:j + 1])[:, 0]
                self.s[:, j] = (xt / self.phi) * self.dom[:, j]
            self.s[n] = (xt[n] / self.phi[n]) * self.dom[n]

    # -- the grant loop --------------------------------------------------------

    def select(self) -> Optional[tuple[int, int]]:
        """Next (framework, server) pick, or None when the epoch is done."""
        if self.kernel:
            return self._select_kernel()
        if not self.feas.any():
            return None
        return self.policy.select(
            self.s, self.feas, server_specific=self.crit.server_specific,
            demands=self.TD, residual=self.FREE,
        )

    def _select_kernel(self) -> Optional[tuple[int, int]]:
        """Fused Pallas score+feasibility+argmin (rPS-DSF pooled).

        Operates on the cached device mirrors (see ``__init__``); the only
        host<->device traffic per pick is the scalar ``(n, j)`` readback
        (the fully fused alternative is :mod:`repro.core.engine_jax`)."""
        ops, _ = _kernel_backend()
        _, n, j = ops.psdsf_argmin(
            self._dev_tot, self._dev_phi, self._dev_kd, self._dev_kres,
        )
        n, j = int(n), int(j)
        if n < 0:
            return None
        return n, j

    def apply(self, n: int, j: int, bundle, n_units: int = 1,
              new_demand_row=None, new_usage_row=None) -> None:
        """Commit a grant and restore score/feasibility consistency."""
        self.X[n, j] += n_units
        self.tot[n] += n_units
        self.FREE[j] = self.FREE[j] - bundle
        self.used[j] += 1
        demand_changed = False
        if new_usage_row is not None and self.usage is not None:
            self.usage[n] = new_usage_row
        if new_demand_row is not None and not np.array_equal(
                self.D[n], new_demand_row):
            self.D[n] = new_demand_row
            demand_changed = True
        if self.kernel:
            # masks ride on the kernel inputs: exhausted frameworks get an
            # unsatisfiable demand row, blocked servers zero residuals.  Only
            # the touched row/column moves host->device.
            _, jnp = _kernel_backend()
            self.cap[j] = self.C[j] - self.X[:, j] @ self.D
            self._kres[j] = self.cap[j]
            if self.limit is not None and self.used[j] >= self.limit:
                self._kres[j] = 0.0
            self._dev_tot = self._dev_tot.at[n].add(float(n_units))
            self._dev_kres = self._dev_kres.at[j].set(
                jnp.asarray(self._kres[j], jnp.float32))
            if self.tot[n] >= self.wanted[n]:
                self._kd[n] = _KBIG
                self._dev_kd = self._dev_kd.at[n].set(_KBIG)
            return
        # feasibility: column j saw FREE change; row n may have hit `wanted`
        wants = self.tot < self.wanted
        self.feas[:, j] = (
            wants & self.allowed[:, j]
            & (self.TD <= self.FREE[j][None, :] + 1e-9).all(axis=1)
        )
        if self.limit is not None and self.used[j] >= self.limit:
            self.feas[:, j] = False
        if not wants[n]:
            self.feas[n, :] = False
        self._refresh_scores(n, j, demand_changed)
