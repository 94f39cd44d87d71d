"""Priority-weighted revocable offers and the epoch-level preemption pass.

The paper's schedulers assume equal-priority frameworks, but every criterion
in :mod:`repro.core.criteria` carries the phi weight end-to-end.  This module
closes the scenario gap: Mesos-style *revocable offers* plus a preemption
pass that revokes them when a starved framework's offer cannot be satisfied
(the DRF-aware multi-tenant revocation mechanism of Tromino / the Mesos
quota machinery, driven by the same criterion scores as allocation).

Firm vs revocable grants
------------------------
Every grant the online allocator makes is classified AT GRANT TIME against
the framework's phi-weighted fair share (:func:`criteria.fair_share_level`:
weighted dominant shares equalize at ``1 / sum_m phi_m``):

  * a grant made while the framework stays AT OR UNDER
    ``threshold * fair_share_level(phi)`` is **firm** — it can never be
    revoked;
  * a grant that pushes the framework's weighted dominant share OVER that
    level is **revocable** — it rides in the ``Xr`` column of the
    :class:`~repro.core.cluster_state.ClusterState` SoA (``Xr <= X``) and
    is the preemption pass's victim pool.

Classification is sticky: a framework that later drops back under its share
keeps its revocable ledger, but the pass only victimizes frameworks that are
CURRENTLY over share, so stale revocable grants of a now-under-share
framework are never revoked.

The preemption pass
-------------------
:func:`preempt_pass` runs ONCE per allocation epoch, on the host, BEFORE the
grant loop — for every engine.  The synchronous per-grant path runs it at
the top of ``OnlineAllocator.allocate()``; the batched host epoch and the
fused device epoch both run it inside ``OnlineAllocator.begin_epoch()``
*before* the frozen ``epoch_view`` upload snapshot is taken, so the device
dispatch (and the async begin/commit protocol riding on it) sees the
post-revocation state and the ``mutation_count`` staleness guard is armed
AFTER the pass.  Because the pass is one shared implementation that consumes
no RNG, the revoke sequence — and therefore the post-revocation epoch input
— is identical across the per-grant, numpy-batched and device paths by
construction; grant-sequence parity then follows from the existing engine
parity contracts (gated in ``tests/test_preemption.py``).

Per round the pass:

  1. computes every framework's weighted dominant share
     (:func:`criteria.usage_dominant_share` on held resources) and the fair
     level (:func:`criteria.fair_share_level`);
  2. finds **starved** frameworks: under the fair level, wanting more tasks,
     whose demand fits no allowed agent's FREE vector;
  3. picks the **victim** by the shared criterion scores — the
     most-over-share dominant user first: the (framework, agent) pair with
     the MAXIMUM criterion score among pairs where an over-share framework
     holds revocable executors on a HELPFUL agent (for global criteria the
     score row is broadcast, matching the TSF ordering; for
     PS-DSF/rPS-DSF the per-server K picks the agent too).  An agent is
     helpful for a starved framework when it is allowed AND its free
     vector plus every over-share victim's revocable bundles there could
     cover the starved demand — revoking anywhere else frees fragments
     that can never help and would be re-grabbed by the victims (thrash).
     Ties resolve to the lowest (framework, agent) index in name-sorted
     order — the same ``tie="low"`` rule the grant loops use;
  4. revokes ONE executor and loops.  The pass stops as soon as no starved
     framework remains (minimal revocation: each epoch frees just enough
     for every starved framework to place at least one task — the grant
     loop right after gives starved frameworks priority anyway, since
     their scores are the lowest) or the revocable pool / per-epoch budget
     is exhausted.

Tenancy hooks (see :mod:`repro.core.tenancy` and ``docs/tenancy.md``):
with a control plane attached the victim rule is floor-aware — a tenant
carrying a quota floor is a candidate iff its AGGREGATE unweighted share
exceeds the floor (at/under-floor tenants are never victims; above-floor
holdings are revocable even for a lone tenant), and credit-shielded
tenants are skipped for the shield window.  Revocation hysteresis
(``hysteresis_epochs``, default 2) additionally protects any
(framework, agent) pair granted within the last k allocation epochs, so
a revoke -> regrant -> revoke oscillation across consecutive epochs is
structurally impossible.

Preemption is characterized-mode only: the oblivious allocator neither
knows true demands (starvation is undetectable) nor grants task quanta
(coarse offers hold slack, which deregistration — not revocation — frees).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import criteria


@dataclasses.dataclass
class Revocation:
    """One revoked executor: the inverse of :class:`repro.core.online.Grant`."""

    fid: str
    agent: str
    bundle: np.ndarray          # resources returned to the agent's FREE pool
    n_executors: int = 1


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Configuration of the revocable-offer / preemption subsystem.

    threshold
        Over-share factor: a grant is revocable (and its holder a victim
        candidate) when the framework's weighted dominant share exceeds
        ``threshold * fair_share_level(phi)``.  1.0 = revoke anything past
        the exact phi-weighted fair share; larger values tolerate more
        over-share before grants become revocable.
    max_revocations_per_epoch
        Hard cap on revocations per pass (None = unlimited; the pass is
        bounded by the revocable pool regardless).
    hysteresis_epochs
        Revocation hysteresis (the ROADMAP follow-on from the PR-5
        fragment-thrash scenario): the pass never revokes from a
        (framework, agent) pair whose most recent grant was made within
        the last ``k`` allocation epochs (``allocator.epoch_counter``
        ticks once per epoch).  Because revocation pops the NEWEST bundle
        (LIFO), protecting the pair while its newest grant is fresh is
        exactly "never revoke a grant made within the last k epochs".
        0 disables the filter (the pre-hysteresis pass semantics most
        unit tests pin).
    eps
        Share-comparison tolerance (absorbs f64 rounding of usage sums).
    """

    threshold: float = 1.0
    max_revocations_per_epoch: Optional[int] = None
    hysteresis_epochs: int = 2
    eps: float = 1e-9


def get_policy(policy) -> Optional[PreemptionPolicy]:
    """Resolve a preemption spec: None | True | PreemptionPolicy."""
    if policy is None or policy is False:
        return None
    if policy is True:
        return PreemptionPolicy()
    if isinstance(policy, PreemptionPolicy):
        return policy
    raise ValueError(f"unknown preemption spec {policy!r}")


def preempt_pass(al) -> list:
    """Run one preemption pass over ``al`` (an ``OnlineAllocator``) and
    return the ordered :class:`Revocation` list (see the module docstring
    for the algorithm).  Mutates the allocator state through
    ``al.revoke_executor`` only — the same O(R) incremental accounting
    every other mutation uses."""
    pol = al.preemption
    cp = al.tenancy
    k = pol.hysteresis_epochs
    revs: list = []
    budget = (pol.max_revocations_per_epoch
              if pol.max_revocations_per_epoch is not None else 1 << 30)
    for _ in range(100_000):
        if len(revs) >= budget:
            break
        view = al.state.sorted_view()
        N, J = view.X.shape
        if N == 0 or J == 0:
            break
        usage = np.array([al.frameworks[f].usage for f in view.fids])
        shares = criteria.usage_dominant_share(usage, view.C, view.phi)
        level = criteria.fair_share_level(view.phi)
        over = shares > pol.threshold * level + pol.eps

        if cp is not None:
            # quota floors override the membership-relative rule: a row
            # whose tenant carries a floor is a victim candidate iff the
            # TENANT's aggregate unweighted share exceeds the floor (and
            # at/under-floor tenants are protected regardless of who else
            # is registered — recomputed per round, so revocations stop AT
            # the floor).  Shielded tenants are protected outright.
            tshares = al._tenant_shares()
            for i, f in enumerate(view.fids):
                t = cp.tenant_of.get(f, f)
                if cp.shield_active(t, al.epoch_counter):
                    over[i] = False
                    continue
                floor = cp.cfg.floor_of(t)
                if floor > 0.0:
                    over[i] = tshares.get(t, 0.0) > floor + pol.eps

        # revocation hysteresis: pairs whose NEWEST grant is younger than
        # k epochs are untouchable this pass — masked out of the victim
        # pool AND of the freeable `potential` below (counting them would
        # declare agents helpful that the pass then cannot actually free).
        Xr = view.Xr
        if k > 0 and al._grant_epoch:
            fidx = {f: i for i, f in enumerate(view.fids)}
            aidx = {a: j for j, a in enumerate(view.agents)}
            fresh = np.zeros((N, J), bool)
            for (f, a), e in al._grant_epoch.items():
                if al.epoch_counter - e < k:
                    i, j = fidx.get(f), aidx.get(a)
                    if i is not None and j is not None:
                        fresh[i, j] = True
            if fresh.any():
                Xr = np.where(fresh, 0.0, Xr)

        # what COULD each agent free: its FREE vector plus every over-share
        # victim's revocable bundles there (characterized mode: one
        # bundle per revocable executor = the framework's demand row).
        potential = view.FREE + np.einsum(
            "nj,nr->jr", np.where(over[:, None], Xr, 0.0), view.D)

        # one-more-task feasibility through the SAME shared formula the
        # grant loops use — against the live FREE (is i placeable now?)
        # and against `potential` (could revocations there open a hole?).
        wants = np.array([al.frameworks[f].n_tasks < al.frameworks[f].wanted_tasks
                          for f in view.fids])
        TD = np.zeros((N, view.D.shape[1]))
        for i, f in enumerate(view.fids):
            if wants[i]:   # same construction begin_epoch uses for its TD
                TD[i] = al._true_demand(f)
        fits_now = criteria.feasible_mask(TD, view.FREE, view.allowed, wants)
        fits_pot = criteria.feasible_mask(TD, potential, view.allowed, wants)

        starved: list[int] = []
        helpful = np.zeros(J, bool)
        for i in range(N):
            if not wants[i]:
                continue
            if shares[i] >= level - pol.eps:
                continue                      # at/over fair share: not starved
            if fits_now[i].any():
                continue                      # placeable without revocation
            # helpful agents for i: allowed, and revocation there can
            # ACCUMULATE to a hole the starved demand fits — revoking
            # anywhere else frees fragments the victims just re-grab.
            if fits_pot[i].any():
                starved.append(i)
                helpful |= fits_pot[i]
        if not starved:
            break

        cand = over[:, None] & helpful[None, :] & (Xr > 0)
        if not cand.any():
            break                             # nothing (useful) to revoke

        scores = al.crit.matrix_scores(view.X, view.D, view.C, view.phi,
                                       lookahead=False, allowed=view.allowed)
        masked = np.where(cand, scores, -np.inf)
        n, j = np.unravel_index(int(np.argmax(masked)), masked.shape)
        revs.append(al.revoke_executor(view.fids[n], view.agents[j]))
    return revs
