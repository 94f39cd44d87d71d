"""The reference's ``tests/test_epoch_cache.py``, retargeted to the port:
``repro_torch`` with ``device="cpu"`` (its entry points run on the card
otherwise).  Every case runs on the port's allocator; the fresh-epoch
parity cases also hold the reference allocator's epoch on the same
cluster.

Precomputed-epoch cache (``repro.core.epoch_cache``).

Contracts pinned here:

  * replay parity — cached epochs replay bit-for-bit vs fresh dispatch
    (grants AND final cluster state AND rng stream position) across all
    four criteria x pooled/rrr x (sync ``allocate_batched``, async
    begin/commit), including fused RRR via the dispatch-time permutation
    prefix and its grow-and-replay extra-draw burn;
  * fingerprint safety by construction — the perturbation matrix: flipping
    any single input field (one demand element, one phi, one allowed bit,
    TD/wanted, criterion, policy, per_agent_limit, preemption threshold,
    RRR perm prefix) MISSES, while process-order-independent rebuilds of
    the same profile HIT;
  * eligibility gates — host RRR, oblivious mode and non-"low" ties bypass
    the cache entirely (no lookups, no stores, no rng perturbation);
  * commit semantics — cached fused epochs keep the ``mutation_count``
    staleness guard and the revocation-refusal window; the preemption pass
    always runs LIVE (revocations never come from the cache);
  * the epoch_view memo (satellite) — identical snapshot object back when
    nothing mutated, and value-unchanged ``set_*`` calls don't invalidate;
  * LRU accounting — byte-budget eviction, hit/miss/store/eviction
    counters, ``get_cache`` spec normalization.
"""
import functools
import numpy as np
import pytest

from repro_torch.core import engine_torch
from repro_torch.core.epoch_cache import (
    EpochCache,
    EpochOutcome,
    get_cache,
    perm_digest,
)
from repro_torch.core.online import OnlineAllocator as _PortAllocator
from repro_torch.core.preemption import PreemptionPolicy


# the port's entry points run on the card unless asked for the CPU
OnlineAllocator = functools.partial(_PortAllocator, device="cpu")

CRITERIA = ("drf", "tsf", "psdsf", "rpsdsf")
POLICIES = ("pooled", "rrr")


def _build(cache=None, *, criterion="drf", policy="pooled", seed=0,
           J=8, N=5, preemption=None, agent_order=None, fw_order=None,
           demand_tweak=None, phi_tweak=None, allowed_tweak=None,
           wanted_tweak=None, cls=None):
    """A small quantized-demand cluster (on the port's allocator, or
    ``cls``); tweak hooks flip ONE field for the perturbation matrix."""
    al = (cls or OnlineAllocator)(2, criterion=criterion, server_policy=policy,
                         seed=seed, epoch_cache=cache, preemption=preemption)
    for j in (agent_order if agent_order is not None else range(J)):
        al.add_agent(f"a{j}", [8.0, 8.0])
    for i in (fw_order if fw_order is not None else range(N)):
        d = [1.0 + 0.5 * (i % 3), 0.5 + 0.25 * i]
        if demand_tweak is not None and i == demand_tweak[0]:
            d[demand_tweak[1]] += 0.25
        phi = 1.0 + (i % 2)
        if phi_tweak is not None and i == phi_tweak:
            phi += 0.5
        allowed = None
        if allowed_tweak is not None and i == allowed_tweak:
            allowed = [f"a{j}" for j in range(J - 1)]   # drop one agent
        wanted = 6
        if wanted_tweak is not None and i == wanted_tweak:
            wanted = 7
        al.register(f"f{i}", demand=d, wanted_tasks=wanted, phi=phi,
                    allowed_agents=allowed)
    return al


def _gkey(grants):
    return [(g.fid, g.agent, g.n_executors, g.revocable) for g in grants]


def _state_key(al):
    v = al.state.sorted_view()
    return (v.fids, v.agents, v.X.tobytes(), v.Xr.tobytes(),
            v.FREE.tobytes())


# ---------------------------------------------------------------------------
# replay parity: cached == fresh, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ("sync", "async"))
def test_cached_equals_fresh(criterion, policy, mode):
    def run(al):
        if mode == "async":
            return al.commit_epoch(al.begin_epoch(use_kernel="fused"))
        return al.allocate_batched(use_kernel="fused")

    fresh = _build(None, criterion=criterion, policy=policy)
    g0 = run(fresh)
    cache = EpochCache()
    miss = _build(cache, criterion=criterion, policy=policy)
    g1 = run(miss)
    hit = _build(cache, criterion=criterion, policy=policy)
    g2 = run(hit)
    assert g0 and _gkey(g0) == _gkey(g1) == _gkey(g2)
    assert cache.hits == 1 and cache.misses == 1
    # final cluster state and rng stream position replay exactly too
    assert _state_key(fresh) == _state_key(miss) == _state_key(hit)
    assert (fresh.rng.bit_generator.state
            == miss.rng.bit_generator.state
            == hit.rng.bit_generator.state)
    # and the reference allocator's fresh epoch on the same cluster
    from repro.core.online import OnlineAllocator as RefAllocator

    ref = _build(None, criterion=criterion, policy=policy, cls=RefAllocator)
    assert _gkey(run(ref)) == _gkey(g0)
    assert _state_key(ref) == _state_key(fresh)
    assert ref.rng.bit_generator.state == fresh.rng.bit_generator.state


@pytest.mark.parametrize("criterion", CRITERIA)
def test_cached_equals_fresh_host_path(criterion):
    """The numpy host epoch caches too (pooled; host RRR is gated off)."""
    cache = EpochCache()
    g0 = _build(None, criterion=criterion).allocate_batched(use_kernel=False)
    g1 = _build(cache, criterion=criterion).allocate_batched(use_kernel=False)
    g2 = _build(cache, criterion=criterion).allocate_batched(use_kernel=False)
    assert g0 and _gkey(g0) == _gkey(g1) == _gkey(g2)
    assert cache.hits == 1 and cache.misses == 1


def test_cached_equals_fresh_bestfit_host():
    cache = EpochCache()
    g0 = _build(None, policy="bestfit").allocate_batched(use_kernel=False)
    g1 = _build(cache, policy="bestfit").allocate_batched(use_kernel=False)
    g2 = _build(cache, policy="bestfit").allocate_batched(use_kernel=False)
    assert g0 and _gkey(g0) == _gkey(g1) == _gkey(g2)
    assert cache.hits == 1


def test_hit_then_mutate_then_miss():
    cache = EpochCache()
    al = _build(cache)
    g1 = al.allocate_batched(per_agent_limit=1, use_kernel="fused")
    assert cache.misses == 1 and cache.hits == 0
    for g in g1:                       # profile recurs exactly on release
        al.release_executor(g.fid, g.agent)
    g2 = al.allocate_batched(per_agent_limit=1, use_kernel="fused")
    assert cache.hits == 1 and _gkey(g1) == _gkey(g2)
    for g in g2:
        al.release_executor(g.fid, g.agent)
    al.add_agent("extra", [8.0, 8.0])  # mutation: the profile changed
    al.allocate_batched(per_agent_limit=1, use_kernel="fused")
    assert cache.hits == 1 and cache.misses == 2


def test_shared_cache_serves_across_allocators():
    """One cache, many allocators — the serving-front-end arrangement."""
    cache = EpochCache()
    _build(cache).allocate_batched(use_kernel="fused")
    for _ in range(3):
        _build(cache).allocate_batched(use_kernel="fused")
    assert cache.misses == 1 and cache.hits == 3


# ---------------------------------------------------------------------------
# fingerprint perturbation matrix: every single-field flip MISSES
# ---------------------------------------------------------------------------

_FLIPS = {
    "demand_element": dict(demand_tweak=(2, 1)),
    "phi": dict(phi_tweak=1),
    "allowed_bit": dict(allowed_tweak=0),
    "wanted_TD": dict(wanted_tweak=3),
    "criterion": dict(criterion="rpsdsf"),
    "policy": dict(policy="rrr"),
}


@pytest.mark.parametrize("flip", sorted(_FLIPS))
def test_perturbation_misses(flip):
    cache = EpochCache()
    _build(cache).allocate_batched(use_kernel="fused")
    _build(cache, **_FLIPS[flip]).allocate_batched(use_kernel="fused")
    assert cache.hits == 0 and cache.misses == 2, cache.stats()
    assert len(cache) == 2


def test_perturbation_per_agent_limit_misses():
    cache = EpochCache()
    _build(cache).allocate_batched(per_agent_limit=1, use_kernel="fused")
    _build(cache).allocate_batched(per_agent_limit=2, use_kernel="fused")
    assert cache.hits == 0 and cache.misses == 2


def test_perturbation_preemption_threshold_misses():
    cache = EpochCache()
    for thr in (1.0, 1.5):
        al = _build(cache, preemption=PreemptionPolicy(threshold=thr))
        al.allocate_batched(use_kernel="fused")
    assert cache.hits == 0 and cache.misses == 2


def test_perturbation_rrr_perm_prefix_misses():
    """Equal profiles under different rng streams never share an entry:
    the dispatch-time permutation prefix is part of the key."""
    cache = EpochCache()
    _build(cache, policy="rrr", seed=0).allocate_batched(use_kernel="fused")
    _build(cache, policy="rrr", seed=1).allocate_batched(use_kernel="fused")
    assert cache.hits == 0 and cache.misses == 2


def test_engine_paths_never_cross_serve():
    """A host-epoch entry must not serve a fused dispatch (documented
    f32/tile tie-semantics boundary): the resolved engine is in the key."""
    cache = EpochCache()
    _build(cache).allocate_batched(use_kernel=False)
    _build(cache).allocate_batched(use_kernel="fused")
    assert cache.hits == 0 and cache.misses == 2


def test_order_independent_rebuild_hits():
    """Registration order cannot leak into the fingerprint: the epoch view
    is name-sorted, so shuffled rebuilds of the same profile HIT."""
    cache = EpochCache()
    g1 = _build(cache).allocate_batched(use_kernel="fused")
    g2 = _build(cache, agent_order=[3, 1, 7, 0, 6, 2, 5, 4],
                fw_order=[4, 0, 2, 1, 3]).allocate_batched(use_kernel="fused")
    assert cache.hits == 1 and cache.misses == 1
    assert _gkey(g1) == _gkey(g2)


# ---------------------------------------------------------------------------
# eligibility gates: ineligible epochs must not even touch the cache
# ---------------------------------------------------------------------------

def test_host_rrr_bypasses_cache():
    cache = EpochCache()
    for _ in range(2):
        _build(cache, policy="rrr").allocate_batched(use_kernel=False)
    assert cache.hits == 0 and cache.misses == 0 and len(cache) == 0


def test_nonlow_tie_bypasses_cache():
    cache = EpochCache()
    for _ in range(2):
        _build(cache).allocate_batched(tie="random", use_kernel=False)
    assert cache.hits == 0 and cache.misses == 0


def test_oblivious_mode_bypasses_cache():
    cache = EpochCache()
    for _ in range(2):
        al = OnlineAllocator(2, criterion="drf", server_policy="pooled",
                             mode="oblivious", epoch_cache=cache)
        al.add_agent("a0", [8.0, 8.0])
        al.register("f0", wanted_tasks=2)
        al.framework_demand_oracle = lambda fid: np.array([1.0, 1.0])
        al.allocate_batched(use_kernel=False)
    assert cache.hits == 0 and cache.misses == 0


# ---------------------------------------------------------------------------
# fused RRR: prefix pre-draw, grow-and-replay extras, digest verification
# ---------------------------------------------------------------------------

def test_rrr_grow_and_replay_extras(monkeypatch):
    """Force the grow-and-replay path (tiny initial budget): the entry
    records the extra draws; a hit burns them and still replays exactly."""
    monkeypatch.setattr(engine_torch, "rrr_perm_budget", lambda *a, **k: 1)
    fresh = _build(None, policy="rrr")
    g0 = fresh.allocate_batched(use_kernel="fused")
    cache = EpochCache()
    miss = _build(cache, policy="rrr")
    g1 = miss.allocate_batched(use_kernel="fused")
    entry = next(iter(cache._entries.values()))
    assert entry.extra_perm_rows > 0 and entry.extra_perm_digest
    hit = _build(cache, policy="rrr")
    g2 = hit.allocate_batched(use_kernel="fused")
    assert cache.hits == 1
    assert _gkey(g0) == _gkey(g1) == _gkey(g2)
    assert (fresh.rng.bit_generator.state
            == miss.rng.bit_generator.state
            == hit.rng.bit_generator.state)


def test_rrr_extra_digest_mismatch_demotes_to_miss(monkeypatch):
    """A corrupted extra-draw digest must rewind the rng and fall back to
    a fresh dispatch — never replay the wrong sequence."""
    monkeypatch.setattr(engine_torch, "rrr_perm_budget", lambda *a, **k: 1)
    cache = EpochCache()
    g1 = _build(cache, policy="rrr").allocate_batched(use_kernel="fused")
    (key, entry), = cache._entries.items()
    cache._entries[key] = entry._replace(extra_perm_digest=b"x" * 20)
    al = _build(cache, policy="rrr")
    g2 = al.allocate_batched(use_kernel="fused")
    assert _gkey(g1) == _gkey(g2)          # fresh dispatch, same profile
    assert cache.hits == 0 and cache.misses == 2, cache.stats()


# ---------------------------------------------------------------------------
# commit semantics on cached epochs
# ---------------------------------------------------------------------------

def _hot_begin(cache):
    """begin_epoch on a hot cache: returns (allocator, cached epoch)."""
    miss = _build(cache)
    miss.commit_epoch(miss.begin_epoch(use_kernel="fused"))
    al = _build(cache)
    epoch = al.begin_epoch(use_kernel="fused")
    assert epoch.cached_seq is not None and epoch.in_flight
    return al, epoch


def test_cached_epoch_keeps_staleness_guard():
    al, epoch = _hot_begin(EpochCache())
    al.state.grant("f0", "a0", np.array([1.0, 0.5]))   # concurrent mutation
    with pytest.raises(RuntimeError, match="mutated"):
        al.commit_epoch(epoch)


def test_cached_epoch_refuses_revocation_in_flight():
    al, epoch = _hot_begin(EpochCache())
    with pytest.raises(RuntimeError, match="in flight"):
        al.revoke_executor("f0", "a0")
    al.commit_epoch(epoch)


def test_cached_epoch_commit_is_single_shot():
    al, epoch = _hot_begin(EpochCache())
    al.commit_epoch(epoch)
    with pytest.raises(RuntimeError, match="already committed"):
        al.commit_epoch(epoch)


def test_preemption_pass_runs_live_on_hits():
    """Revocations come from the live pass at begin, never the cache: a
    repeat of a preemption-triggering profile replays grants from the
    cache AND still emits the same revocations."""
    def starve(cache):
        al = OnlineAllocator(2, criterion="drf", server_policy="pooled",
                             seed=0,
                             preemption=PreemptionPolicy(hysteresis_epochs=0),
                             epoch_cache=cache)
        al.add_agent("a0", [8.0, 8.0])
        al.register("f0", demand=(2.0, 2.0), wanted_tasks=1)
        al.register("f1", demand=(1.0, 1.0), wanted_tasks=100)
        al.allocate_batched(use_kernel="fused")
        al.set_wanted("f0", 3)
        gs = al.allocate_batched(use_kernel="fused")
        return gs, [(r.fid, r.agent, r.n_executors)
                    for r in al.last_revocations]

    g0, r0 = starve(None)
    cache = EpochCache()
    g1, r1 = starve(cache)
    g2, r2 = starve(cache)
    assert r0 and r0 == r1 == r2
    assert _gkey(g0) == _gkey(g1) == _gkey(g2)
    assert cache.hits >= 1


# ---------------------------------------------------------------------------
# epoch_view memoization (satellite)
# ---------------------------------------------------------------------------

def test_epoch_view_memoized_on_mutation_count():
    al = _build(None)
    v1 = al.state.epoch_view()
    assert al.state.epoch_view() is v1          # no mutation: same snapshot
    al.state.set_wanted("f0", 6.0)              # value unchanged: no tick
    assert al.state.epoch_view() is v1
    al.state.set_wanted("f0", 9.0)
    v2 = al.state.epoch_view()
    assert v2 is not v1 and v2.wanted[0] == 9.0
    al.state.grant("f0", "a0", np.array([1.0, 0.75]))
    assert al.state.epoch_view() is not v2


def test_value_unchanged_setters_do_not_tick():
    al = _build(None)
    m0 = al.state.mutation_count
    al.state.set_wanted("f1", 6.0)
    al.state.set_weight("f1", 2.0)
    al.state.set_demand("f1", np.array([1.5, 0.75]))
    assert al.state.mutation_count == m0
    al.state.set_weight("f1", 3.0)
    assert al.state.mutation_count == m0 + 1


# ---------------------------------------------------------------------------
# LRU accounting & spec normalization
# ---------------------------------------------------------------------------

def test_lru_evicts_by_byte_budget():
    cache = EpochCache(max_bytes=1024)
    seq = tuple((i, i) for i in range(20))
    for k in range(16):
        cache.store(bytes([k]) * 20, EpochOutcome(seq))
    assert cache.evictions > 0
    assert cache.bytes <= cache.max_bytes
    assert cache.stores == 16 and len(cache) < 16


def test_lru_recency_order():
    cache = EpochCache(max_bytes=3 * (16 * 4 + 64 + 20) + 10)
    keys = [bytes([k]) * 20 for k in range(3)]
    for k in keys:
        cache.store(k, EpochOutcome(((0, 0),) * 4))
    assert cache.lookup(keys[0]) is not None    # bump 0 hot
    cache.store(bytes([9]) * 20, EpochOutcome(((0, 0),) * 4))
    assert cache.lookup(keys[1]) is None        # 1 was coldest -> evicted
    assert cache.lookup(keys[0]) is not None


def test_eviction_prefers_least_hit_in_cold_window():
    """Recurrence-aware twist: among the EVICT_WINDOW coldest entries,
    the one with the fewest lifetime hits goes first — a cold-but-
    recurrent profile outlives a once-seen one that happens to be less
    stale."""
    entry = 16 * 4 + 64 + 20
    cache = EpochCache(max_bytes=4 * entry + 10)
    keys = [bytes([k]) * 20 for k in range(4)]
    for k in keys:
        cache.store(k, EpochOutcome(((0, 0),) * 4))
    cache.lookup(keys[0]); cache.lookup(keys[0])   # recurrent: 2 hits
    for k in keys[1:]:
        cache.lookup(k)                            # 1 hit each
    # recency order is again k0 < k1 < k2 < k3; pure LRU would evict k0
    cache.store(bytes([9]) * 20, EpochOutcome(((0, 0),) * 4))
    assert keys[0] in cache._entries               # saved by its hit count
    assert keys[1] not in cache._entries           # least-hit in the window
    assert all(k in cache._entries for k in keys[2:])


def test_eviction_pure_lru_on_hit_ties():
    entry = 16 * 4 + 64 + 20
    cache = EpochCache(max_bytes=4 * entry + 10)
    keys = [bytes([k]) * 20 for k in range(4)]
    for k in keys:
        cache.store(k, EpochOutcome(((0, 0),) * 4))
    cache.store(bytes([9]) * 20, EpochOutcome(((0, 0),) * 4))
    assert keys[0] not in cache._entries           # all hits tie -> coldest
    assert all(k in cache._entries for k in keys[1:])


def test_spill_preserves_hit_counts_and_order(tmp_path):
    from repro_torch.core.epoch_cache import seq_digest_of

    cache = EpochCache()
    keys = [bytes([k]) * 20 for k in range(3)]
    for k in keys:
        seq = ((0, 0),) * 4
        cache.store(k, EpochOutcome(seq, seq_digest=seq_digest_of(seq)))
    cache.lookup(keys[1]); cache.lookup(keys[1])
    path = str(tmp_path / "spill.bin")
    cache.save(path)
    cold = EpochCache()
    assert cold.load(path)["loaded"] == 3
    assert cold._hits_by_key == cache._hits_by_key
    assert list(cold._entries) == list(cache._entries)   # recency order too


def test_get_cache_spec():
    assert get_cache(None) is None and get_cache(False) is None
    assert isinstance(get_cache(True), EpochCache)
    assert get_cache(4096).max_bytes == 4096
    c = EpochCache()
    assert get_cache(c) is c
    with pytest.raises(ValueError):
        get_cache("yes")


def test_perm_digest_is_order_sensitive():
    a = np.array([[0, 1, 2], [2, 1, 0]])
    assert perm_digest(a) != perm_digest(a[::-1])


# ---------------------------------------------------------------------------
# simulator / metrics plumbing
# ---------------------------------------------------------------------------

def test_simulator_cache_stats_plumbing():
    from repro_torch.core.simulator import run_paper_experiment

    r0 = run_paper_experiment("drf", "characterized", server_policy="bestfit",
                              jobs_per_queue=1, batched=True, device="cpu")
    assert r0.cache_stats is None
    r1 = run_paper_experiment("drf", "characterized", server_policy="bestfit",
                              jobs_per_queue=1, batched=True,
                              epoch_cache=True, device="cpu")
    assert r1.cache_stats is not None and r1.cache_stats["misses"] > 0
    # telemetry-only: the cache never changes the simulated outcome
    assert r1.makespan == r0.makespan
    assert np.array_equal(r1.timeline, r0.timeline)


def test_latency_stats_and_cache_hook():
    from repro_torch.core.metrics import CacheStatsHook, LatencyStats

    ls = LatencyStats(max_samples=8)
    for i in range(20):
        ls.record(0.010, count=2)
    s = ls.summary()
    assert s["decisions"] == 40 and abs(s["p50_ms"] - 5.0) < 1e-6
    assert len(ls._samples) <= 8

    hook = CacheStatsHook()
    assert hook.summary() == {}             # inert without a cache
