"""Ledger invariant auditor for the online allocator.

The chaos harness's ground truth (docs/robustness.md): after any sequence
of grants, releases, revocations, agent churn, framework churn, injected
faults and recoveries, the allocator's two representations of the world —
the dense :class:`~repro.core.cluster_state.ClusterState` ledger and the
per-framework :class:`~repro.core.online.FrameworkState` dicts — must agree
exactly, and both must conserve resources:

  * ``0 <= Xr <= X`` elementwise, and ``X/Xr`` carry no mass outside the
    live (framework, agent) pairs;
  * per-agent fills: ``C[j] - FREE[j]`` equals the sum of bundles (and
    coarse-offer slack) every framework holds on agent j, with
    ``0 <= FREE <= C``;
  * ``X`` row sums equal ``FrameworkState.n_tasks`` and each ``X[n, j]``
    equals ``len(fw.tasks[agent_j])`` (``Xr[n, j]`` likewise equals the
    revocable count, bounded by the held count);
  * the ``usage``/``phi``/``wanted``/``D`` mirrors in ClusterState match
    the FrameworkState they shadow;
  * at commit, the frozen epoch view still equals the live state
    (:func:`check_view_agreement` — the direct proof behind the
    ``mutation_count`` staleness guard).

Cost: one walk over the held executors plus vectorized comparisons over the
active (N, J) ledger — linear in the ledger size, cheap enough to run after
every commit (``SimConfig.audit=True`` / ``OnlineAllocator(audit=True)``;
the ``allocator_bench --quick`` smoke pins the audit-on epoch overhead at
<= 1.1x).
"""
from __future__ import annotations

import numpy as np


class InvariantViolation(AssertionError):
    """The allocator ledger broke an invariant (see module docstring)."""


def check(al, *, atol: float = 1e-6) -> list:
    """Audit the live ledger of an OnlineAllocator.

    Returns a list of human-readable violations (empty = ledger is green).
    Use :func:`assert_invariants` to raise instead."""
    st = al.state
    errs: list = []

    agents = list(st.agent2slot)
    a_index = {a: k for k, a in enumerate(agents)}
    ai = np.fromiter(st.agent2slot.values(), np.intp, len(agents))
    J = len(agents)
    R = st.R

    fids = list(al.frameworks)
    fi = np.empty(len(fids), np.intp)
    for n, fid in enumerate(fids):
        slot = st.fid2slot.get(fid)
        if slot is None:
            errs.append(f"framework {fid!r} missing from ClusterState")
            slot = 0
        fi[n] = slot
    for fid in st.fid2slot:
        if fid not in al.frameworks:
            errs.append(f"ClusterState holds unknown framework {fid!r}")
    for name in st.agent2slot:
        if not st.agent_active[st.agent2slot[name]]:
            errs.append(f"agent {name!r} mapped to an inactive slot")
    if errs:
        return errs   # structurally broken: matrix checks would misindex

    X = st.X[np.ix_(fi, ai)] if len(fids) and J else np.zeros((len(fids), J))
    Xr = st.Xr[np.ix_(fi, ai)] if len(fids) and J else np.zeros((len(fids), J))
    FREE = st.FREE[ai] if J else np.zeros((0, R))
    C = st.C[ai] if J else np.zeros((0, R))

    # -- ledger bounds -------------------------------------------------------
    if (Xr < -atol).any():
        errs.append("Xr < 0 (negative revocable count)")
    if (Xr > X + atol).any():
        errs.append("Xr > X (more revocable than held executors)")
    if (X < -atol).any():
        errs.append("X < 0 (negative executor count)")
    if (FREE < -atol).any():
        errs.append(f"FREE < 0 (overcommitted agent: min={FREE.min():.6g})")
    if (FREE > C + atol).any():
        errs.append("FREE > C (agent freed more than its capacity)")

    # -- expected ledger from the FrameworkState side ------------------------
    # One walk collecting every held bundle / slack row into flat lists, then
    # two scatter-adds — keeps the audit O(grants) Python work with a handful
    # of vectorized numpy calls instead of per-framework reductions.
    EX = np.zeros((len(fids), J))
    EXr = np.zeros((len(fids), J))
    fills = np.zeros((J, R))
    EU = np.zeros((len(fids), R))         # expected per-framework usage
    row_n: list = []                      # framework index per held row
    row_k: list = []                      # agent index per held row
    row_v: list = []                      # resource vector per held row
    n_tasks = np.empty(len(fids))
    wanted = np.empty(len(fids))
    phi = np.empty(len(fids))
    RU = np.zeros((len(fids), R))         # recorded per-framework usage
    ED = np.zeros((len(fids), R))         # expected demand mirror
    has_d = np.zeros(len(fids), bool)
    for n, fid in enumerate(fids):
        fw = al.frameworks[fid]
        for agent, bundles in fw.tasks.items():
            k = a_index.get(agent)
            if k is None:
                if bundles:
                    errs.append(f"{fid!r} holds executors on unknown "
                                f"agent {agent!r}")
                continue
            for b in bundles:
                row_n.append(n)
                row_k.append(k)
                row_v.append(b)
            EX[n, k] = len(bundles)
        for agent, rev in fw.revocable.items():
            if rev < 0:
                errs.append(f"{fid!r} revocable count < 0 on {agent!r}")
            k = a_index.get(agent)
            if k is not None:
                EXr[n, k] = rev
                if rev > EX[n, k] + atol:
                    errs.append(f"{fid!r} on {agent!r}: revocable {rev} > "
                                f"held {int(EX[n, k])}")
        for agent, s in fw.slack.items():
            k = a_index.get(agent)
            if k is not None:
                row_n.append(n)
                row_k.append(k)
                row_v.append(s)
        n_tasks[n] = fw.n_tasks
        wanted[n] = float(fw.wanted_tasks)
        phi[n] = fw.phi
        RU[n] = fw.usage
        if fw.demand is not None:
            ED[n] = fw.demand
            has_d[n] = True
    if row_v:
        V = np.asarray(row_v, float)
        np.add.at(fills, np.asarray(row_k, np.intp), V)
        np.add.at(EU, np.asarray(row_n, np.intp), V)

    if not np.allclose(EU, RU, atol=atol):
        for n in np.flatnonzero(~np.isclose(EU, RU, atol=atol).all(axis=1)):
            errs.append(f"{fids[n]!r} usage ledger drift: held {EU[n]} vs "
                        f"recorded {RU[n]}")
    row_sum = X.sum(axis=1) if J else np.zeros(len(fids))
    for n in np.flatnonzero(np.abs(row_sum - n_tasks) > atol):
        errs.append(f"{fids[n]!r} X row sum {row_sum[n]:.6g} != n_tasks "
                    f"{n_tasks[n]:.6g}")
    for n in np.flatnonzero(st.wanted[fi] != wanted):
        errs.append(f"{fids[n]!r} wanted mirror {st.wanted[fi[n]]:.6g} != "
                    f"{wanted[n]:.6g}")
    for n in np.flatnonzero(np.abs(st.phi[fi] - phi) > atol):
        errs.append(f"{fids[n]!r} phi mirror {st.phi[fi[n]]:.6g} != {phi[n]}")
    D_live = st.D[fi] if len(fids) else np.zeros((0, R))
    if len(fids) and not np.allclose(D_live[has_d], ED[has_d], atol=atol):
        for n in np.flatnonzero(
                has_d & ~np.isclose(D_live, ED, atol=atol).all(axis=1)):
            errs.append(f"{fids[n]!r} demand mirror drifted")

    if not np.allclose(X, EX, atol=atol):
        bad = int(np.sum(~np.isclose(X, EX, atol=atol)))
        errs.append(f"X disagrees with FrameworkState.tasks at {bad} cells")
    if not np.allclose(Xr, EXr, atol=atol):
        bad = int(np.sum(~np.isclose(Xr, EXr, atol=atol)))
        errs.append(f"Xr disagrees with FrameworkState.revocable at "
                    f"{bad} cells")
    if J and not np.allclose(C - FREE, fills, atol=max(atol, 1e-6)):
        bad = np.argmax(np.abs((C - FREE) - fills).sum(axis=1))
        errs.append(f"per-agent fill mismatch (worst: {agents[int(bad)]!r}: "
                    f"C-FREE={C[bad] - FREE[bad]} vs held={fills[bad]})")

    # -- no stray mass outside live rows/columns -----------------------------
    live_f = np.zeros(st.X.shape[0], bool)
    live_f[fi] = True
    live_a = np.zeros(st.X.shape[1], bool)
    live_a[ai] = True
    stray = st.X[~live_f].sum() + st.X[:, ~live_a].sum()
    if abs(stray) > atol:
        errs.append(f"X carries {stray:.6g} executors outside live slots")

    # -- tenancy control plane (when attached) -------------------------------
    cp = getattr(al, "tenancy", None)
    if cp is not None:
        for t in sorted(set(cp.credits) | set(cp.accrued) | set(cp.spent)):
            bal = cp.credits.get(t, 0.0)
            acc = cp.accrued.get(t, 0.0)
            sp = cp.spent.get(t, 0.0)
            if abs(acc - sp - bal) > max(atol, cp.cfg.eps):
                errs.append(f"tenant {t!r} credit conservation broken: "
                            f"accrued {acc:.6g} - spent {sp:.6g} != "
                            f"balance {bal:.6g}")
            if bal < -max(atol, cp.cfg.eps):
                errs.append(f"tenant {t!r} credit balance negative: {bal:.6g}")
        queued = [e.fid for e in cp.queue]
        if len(set(queued)) != len(queued):
            errs.append(f"admission queue holds duplicate fids: {queued}")
        for fid in queued:
            if fid in al.frameworks:
                errs.append(f"{fid!r} both queued for admission and "
                            f"registered")
    return errs


def assert_invariants(al, *, atol: float = 1e-6) -> None:
    """Raise :class:`InvariantViolation` listing every broken invariant."""
    errs = check(al, atol=atol)
    if errs:
        head = errs[:20]
        more = f" (+{len(errs) - 20} more)" if len(errs) > 20 else ""
        raise InvariantViolation("; ".join(head) + more)


def recovery_parity(ref, rec) -> list:
    """Bit-for-bit parity check between a reference allocator and one
    recovered from its journal/snapshot (docs/robustness.md, Durability).

    Exact equality, no tolerances: recovery replays the original float
    operations in the original order from the original arrays, so any
    drift at all means the journal replayed something the live run never
    did.  Returns human-readable mismatches (empty = bit-identical);
    :func:`assert_recovery_parity` raises instead."""
    errs: list = []
    v1, v2 = ref.state.sorted_view(), rec.state.sorted_view()
    if v1.fids != v2.fids:
        errs.append(f"framework membership: {v1.fids} vs {v2.fids}")
    if v1.agents != v2.agents:
        errs.append(f"agent membership: {v1.agents} vs {v2.agents}")
    if errs:
        return errs
    for name in ("X", "Xr", "D", "C", "FREE", "phi", "allowed", "wanted"):
        a, b = getattr(v1, name), getattr(v2, name)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(a, b)):
            errs.append(f"ledger array {name} differs")
    for fid in ref.frameworks:
        f1, f2 = ref.frameworks[fid], rec.frameworks.get(fid)
        if f2 is None:
            continue   # membership mismatch already reported above
        if not np.array_equal(f1.usage, f2.usage):
            errs.append(f"{fid!r} usage differs")
        if (f1.demand is None) != (f2.demand is None) or (
                f1.demand is not None
                and not np.array_equal(f1.demand, f2.demand)):
            errs.append(f"{fid!r} demand differs")
        if f1.wanted_tasks != f2.wanted_tasks or f1.phi != f2.phi:
            errs.append(f"{fid!r} wanted/phi differs")
        if f1.grants != f2.grants:
            errs.append(f"{fid!r} grant count {f1.grants} vs {f2.grants}")
        if sorted(f1.revocable.items()) != sorted(f2.revocable.items()):
            errs.append(f"{fid!r} revocable ledger differs")
        for agent in set(f1.tasks) | set(f2.tasks):
            b1 = f1.tasks.get(agent, [])
            b2 = f2.tasks.get(agent, [])
            if len(b1) != len(b2) or any(
                    not np.array_equal(x, y) for x, y in zip(b1, b2)):
                errs.append(f"{fid!r} bundles on {agent!r} differ")
                break
    if ref.rng.bit_generator.state != rec.rng.bit_generator.state:
        errs.append("rng stream position differs")
    if ref.epoch_counter != rec.epoch_counter:
        errs.append(f"epoch counter {ref.epoch_counter} vs "
                    f"{rec.epoch_counter}")
    if ref._grant_epoch != rec._grant_epoch:
        errs.append("hysteresis grant-epoch ledger differs")
    cp1, cp2 = ref.tenancy, rec.tenancy
    if (cp1 is None) != (cp2 is None):
        errs.append("tenancy control plane attached on one side only")
    elif cp1 is not None:
        if cp1.state_dict() != cp2.state_dict():
            errs.append("tenancy control-plane state differs (queue/"
                        "credits/shields)")
    return errs


def assert_recovery_parity(ref, rec) -> None:
    """Raise :class:`InvariantViolation` unless ``rec`` is bit-identical
    to ``ref`` (see :func:`recovery_parity`)."""
    errs = recovery_parity(ref, rec)
    if errs:
        raise InvariantViolation("recovery parity: " + "; ".join(errs[:20]))


def check_view_agreement(al, view, *, atol: float = 0.0) -> None:
    """Prove a frozen epoch view still equals the live state (commit time).

    The ``mutation_count`` guard is the fast proxy; this is the direct
    check the chaos harness runs under audit mode.  Raises
    :class:`InvariantViolation` on any divergence."""
    if view is None:
        return
    live = al.state.epoch_view()
    if live is view:   # memoized on mutation_count: same object = agreement
        return
    if view.fids != live.fids or view.agents != live.agents:
        raise InvariantViolation(
            "frozen epoch view and live state disagree on membership")
    for name in ("X", "Xr", "D", "C", "FREE", "phi", "allowed", "wanted"):
        a, b = getattr(view, name), getattr(live, name)
        if a is None and b is None:
            continue
        ok = (np.array_equal(a, b) if atol == 0.0
              else np.allclose(a, b, atol=atol))
        if not ok:
            raise InvariantViolation(
                f"frozen epoch view diverged from live state in {name}")
