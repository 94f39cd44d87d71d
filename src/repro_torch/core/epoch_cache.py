"""Precomputed-epoch cache: content-addressed grant sequences for O(1)
repeat-profile allocation decisions.

Motivation (Precomputed DRF, arXiv 2507.08846): a fair-allocation sequence
is a pure function of the demand profile, so in steady-state traffic —
where the same (demands, capacities, weights) profile arrives over and over
— the fill loop only ever needs to run ONCE per distinct profile.  Our
allocation epochs already are pure functions of the frozen
:meth:`~repro.core.cluster_state.ClusterState.epoch_view` snapshot (the PR-4
begin/commit protocol), which makes the cache a lookup table in front of the
engine: fingerprint the frozen inputs, replay the recorded grant sequence on
a hit, dispatch exactly as today on a miss.

Fingerprint
-----------
:meth:`EpochCache.fingerprint` hashes (blake2b) a canonical byte encoding of
every input the epoch outcome depends on:

  * the frozen view arrays — ``D, C, X, Xr, FREE, phi, allowed, wanted`` —
    plus the true-demand matrix ``TD``, each tagged and length/shape-prefixed
    so fields can never run into each other;
  * the configuration — criterion, server policy, mode, tie rule, engine
    path (host / host-pergrant / fused), ``per_agent_limit``, the best-fit
    metric, and the preemption config (threshold, eps);
  * for fused RRR epochs, the **dispatch-time permutation prefix**: since
    PR 4 all rng consumption happens at dispatch, the pre-drawn permutation
    stack (whose height :func:`~repro.core.engine_jax.rrr_perm_budget` is a
    pure function of the profile) is drawn BEFORE lookup and hashed into
    the key — two epochs with equal profiles but different rng streams can
    never share an entry.

The view arrays are *name-sorted* (``epoch_view``), so fingerprints are
independent of registration / dict-process order by construction: clusters
built in any order that freeze to the same matrices hit the same entry.
Framework/agent *names* are deliberately NOT part of the key — the cached
outcome is a sequence of (framework-index, agent-index) pairs into the
sorted view, replayed against whatever names occupy those rows at commit.

What is cached, what stays live
-------------------------------
An entry stores the epoch's full outcome: the grant-index sequence exactly
as the engine would read it back (the f64 re-validation and the live
:meth:`~repro.core.online.OnlineAllocator._grant` application — including
revocable-offer classification — run on REPLAY too, so a hit mutates state
bit-for-bit like a fresh dispatch), plus the RRR grow-and-replay draw count
and digest.  The epoch-level preemption pass always runs LIVE at begin time
(it mutates state based on live framework structure before the view is
frozen); its revocations ride on the ``InFlightEpoch``, never on the cache.
Oblivious mode is never cached: its mid-epoch inferred-demand drift reads
live framework state outside the frozen view.

Eviction & telemetry
--------------------
Entries live in an LRU ordered by last use and bounded by a byte budget
(``max_bytes``); stores that push past the budget evict from the cold end,
with a recurrence-aware twist: the victim is the LEAST-HIT entry among the
``EVICT_WINDOW`` coldest (ties by recency, i.e. plain LRU), so a burst of
once-seen profiles cannot push out a hot recurring one that briefly aged
to the cold end.  ``hits / misses / stores / evictions`` counters (and
``hit_rate``) are exposed via :meth:`EpochCache.stats` — surfaced per
simulation cell in ``benchmarks/scenario_sweep.py`` and per serve run in
``repro.launch.alloc_serve``.

Persistence
-----------
:meth:`EpochCache.save` spills the entry table to a CRC-framed file
(atomic temp + rename) and :meth:`EpochCache.load` warms a cache from one:
every entry re-verifies its ``seq_digest`` on load, and corrupt,
unpicklable, digest-less or digest-mismatched entries are dropped and
counted (``load_dropped``) — a damaged spill degrades to a colder cache,
never to serving garbage.  The serve front-end's ``--state-dir`` warm
restart is built on this pair.

A single :class:`EpochCache` may be shared by many allocators (the serving
front-end's repeat-profile hits come from exactly that): it holds no
allocator state, only profile -> outcome mappings.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import struct
import zlib
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np

#: default LRU byte budget (~32 MiB holds ~10^5 hundred-grant outcomes)
DEFAULT_MAX_BYTES = 32 << 20

#: eviction candidate window: the victim is the least-hit of this many
#: entries at the cold end (ties fall back to plain LRU order)
EVICT_WINDOW = 4

#: spill-file header ("1" = format version; foreign headers load nothing)
_SPILL_MAGIC = b"RPROEPC1"
_FRAME = struct.Struct("<II")

_DIGEST_SIZE = 20


class EpochOutcome(NamedTuple):
    """The cached result of one allocation epoch.

    ``seq`` is the raw (framework-index, agent-index) grant sequence as the
    engine produced it — BEFORE the f64 re-validation, which reruns live on
    replay.  ``extra_perm_rows`` / ``extra_perm_digest`` record the RRR
    grow-and-replay permutations drawn PAST the fingerprinted prefix: a hit
    burns that many draws from the allocator rng (keeping the stream
    position identical to a fresh run) and verifies their digest — on a
    mismatch the entry is treated as a miss and the rng rewound, so an
    (astronomically unlikely) prefix collision between different streams
    can never replay the wrong sequence.

    ``seq_digest`` is a blake2b digest of the grant sequence itself,
    verified on every hit (:func:`verify_seq`): a corrupted entry — bit
    rot, a bad actor, or the chaos harness's injected corruption — is
    evicted and the epoch falls back to a fresh dispatch instead of
    committing garbage.  Empty = legacy/unverified entry."""

    seq: tuple                       # ((n, j), ...) into the sorted view
    extra_perm_rows: int = 0         # RRR grow-and-replay draws past prefix
    extra_perm_digest: bytes = b""   # digest of those draws (verification)
    seq_digest: bytes = b""          # digest of seq (hit integrity check)

    @property
    def nbytes(self) -> int:
        return (16 * len(self.seq) + len(self.extra_perm_digest)
                + len(self.seq_digest) + 64)


def perm_digest(perms: np.ndarray) -> bytes:
    """Order-sensitive digest of a permutation stack (rows as drawn)."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(np.ascontiguousarray(perms, np.int64).tobytes())
    return h.digest()


def seq_digest_of(seq) -> bytes:
    """Digest of a grant sequence (length-prefixed so () and ((0,0),)*0
    pads can't collide) — stored at cache-populate, checked on every hit."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    h.update(len(seq).to_bytes(8, "little"))
    if len(seq):
        h.update(np.ascontiguousarray(np.asarray(seq, np.int64)).tobytes())
    return h.digest()


def verify_seq(outcome: EpochOutcome) -> bool:
    """Hit-integrity check: does the stored sequence match its digest?

    Legacy entries (no digest) pass vacuously — integrity is opt-in per
    entry so old pickled/constructed outcomes keep working."""
    if not outcome.seq_digest:
        return True
    return seq_digest_of(outcome.seq) == outcome.seq_digest


def _hash_field(h, tag: bytes, payload: bytes) -> None:
    """Tag + length-prefix every field so encodings can never collide
    across field boundaries (b'ab'+b'c' vs b'a'+b'bc')."""
    h.update(tag)
    h.update(len(payload).to_bytes(8, "little"))
    h.update(payload)


def _hash_array(h, tag: bytes, arr: np.ndarray) -> None:
    a = np.ascontiguousarray(arr)
    meta = f"{a.dtype.str}{a.shape}".encode()
    _hash_field(h, tag + b"#", meta)
    _hash_field(h, tag, a.tobytes())


class EpochCache:
    """Content-addressed LRU of precomputed epoch outcomes (module doc)."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[bytes, EpochOutcome] = OrderedDict()
        self._hits_by_key: dict[bytes, int] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.corruption_evictions = 0
        self.spills = 0
        self.loads = 0
        self.load_dropped = 0

    def __len__(self) -> int:
        return len(self._entries)

    # -- fingerprint ---------------------------------------------------------

    @staticmethod
    def fingerprint(view, TD, *, criterion: str, policy: str, mode: str,
                    tie: str, engine: str,
                    per_agent_limit: Optional[int] = None,
                    bf_metric: Optional[str] = None,
                    preemption: Optional[tuple] = None,
                    perms: Optional[np.ndarray] = None) -> bytes:
        """Byte-stable key over everything the epoch outcome depends on.

        ``view`` is a frozen :class:`~repro.core.cluster_state.StateView`
        (name-sorted, so dict/registration order cannot leak in); ``TD`` the
        (N, R) true-demand matrix; ``engine`` the resolved backend path
        (``host`` / ``host-pergrant`` / ``fused`` — entries never cross the
        documented f32/tile tie-semantics boundaries); ``preemption`` is
        ``(threshold, eps)`` or None; ``perms`` the dispatch-time RRR
        permutation prefix (fused RRR only)."""
        h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
        meta = "|".join((
            "epoch-v1", criterion, policy, mode, tie, engine,
            repr(per_agent_limit), repr(bf_metric), repr(preemption),
        )).encode()
        _hash_field(h, b"meta", meta)
        _hash_array(h, b"X", view.X)
        _hash_array(h, b"Xr", view.Xr if view.Xr is not None
                    else np.zeros_like(view.X))
        _hash_array(h, b"D", view.D)
        _hash_array(h, b"C", view.C)
        _hash_array(h, b"FREE", view.FREE)
        _hash_array(h, b"phi", view.phi)
        _hash_array(h, b"allowed", view.allowed)
        _hash_array(h, b"wanted", view.wanted)
        _hash_array(h, b"TD", np.asarray(TD))
        if perms is not None:
            _hash_array(h, b"perms", np.asarray(perms, np.int64))
        return h.digest()

    # -- LRU -----------------------------------------------------------------

    def lookup(self, key: bytes) -> Optional[EpochOutcome]:
        """Return the cached outcome (bumping it hot) or None; counts."""
        out = self._entries.get(key)
        if out is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        self._hits_by_key[key] = self._hits_by_key.get(key, 0) + 1
        return out

    def unhit(self, key: bytes) -> None:
        """Demote a counted hit back to a miss (the RRR extra-draw digest
        failed verification — see :class:`EpochOutcome`)."""
        self.hits -= 1
        self.misses += 1

    def store(self, key: bytes, outcome: EpochOutcome) -> None:
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes + len(key)
        self._entries[key] = outcome
        self._hits_by_key.setdefault(key, 0)
        self.bytes += outcome.nbytes + len(key)
        self.stores += 1
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        """Evict until under budget: the LEAST-HIT entry among the
        ``EVICT_WINDOW`` coldest (``min`` is stable, so all-equal hit
        counts degrade to plain LRU).  The window excludes the hottest
        entry so the entry just stored can never evict itself while a
        colder candidate exists."""
        while self.bytes > self.max_bytes and len(self._entries) > 1:
            width = min(EVICT_WINDOW, len(self._entries) - 1)
            cand = []
            for k in self._entries:
                cand.append(k)
                if len(cand) >= width:
                    break
            victim = min(cand, key=lambda k: self._hits_by_key.get(k, 0))
            out = self._entries.pop(victim)
            self._hits_by_key.pop(victim, None)
            self.bytes -= out.nbytes + len(victim)
            self.evictions += 1

    def evict_corrupt(self, key: bytes) -> None:
        """Drop a corrupted entry (hit-time ``seq_digest`` mismatch) and
        demote its counted hit to a miss — the caller falls back to a
        fresh dispatch, which re-stores a clean entry on commit."""
        out = self._entries.pop(key, None)
        if out is not None:
            self.bytes -= out.nbytes + len(key)
        self._hits_by_key.pop(key, None)
        self.corruption_evictions += 1
        self.unhit(key)

    def corrupt_entry(self, rng=None) -> Optional[bytes]:
        """Chaos helper: flip the first grant of one cached sequence while
        keeping its (now stale) digest, returning the corrupted key — the
        next hit must detect and evict it.  Returns None if no entry holds
        a non-empty digested sequence."""
        keys = [k for k, v in self._entries.items()
                if v.seq and v.seq_digest]
        if not keys:
            return None
        idx = 0 if rng is None else int(rng.integers(len(keys)))
        key = keys[idx]
        out = self._entries[key]
        n, j = out.seq[0]
        self._entries[key] = out._replace(
            seq=((n + 1, j),) + tuple(out.seq[1:]))
        return key

    def clear(self) -> None:
        self._entries.clear()
        self._hits_by_key.clear()
        self.bytes = 0

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> int:
        """Spill the entry table to ``path`` (CRC-framed entries, coldest
        first so a truncated load preserves the hottest tail; atomic temp +
        rename so a crash mid-spill leaves the previous file intact).
        Returns the number of entries written."""
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(_SPILL_MAGIC)
            for key, out in self._entries.items():
                blob = pickle.dumps(
                    (key, tuple(out), self._hits_by_key.get(key, 0)),
                    protocol=4)
                f.write(_FRAME.pack(len(blob), zlib.crc32(blob)))
                f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.spills += 1
        return len(self._entries)

    def load(self, path: str) -> dict:
        """Warm this cache from a spill file, verifying every entry.

        Entries failing the CRC, unpicklable, carrying no ``seq_digest``,
        or whose sequence contradicts its digest are dropped and counted
        (never served); scanning continues past a bad frame, so one rotten
        entry costs one entry, not the file.  Keys already live in this
        cache win over spilled ones.  Returns
        ``{"loaded", "dropped", "torn_bytes"}``."""
        result = {"loaded": 0, "dropped": 0, "torn_bytes": 0}
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return result
        if not data.startswith(_SPILL_MAGIC):
            return result
        off = len(_SPILL_MAGIC)
        while off + _FRAME.size <= len(data):
            ln, crc = _FRAME.unpack_from(data, off)
            end = off + _FRAME.size + ln
            if end > len(data):
                break                     # partial final frame: torn tail
            blob = data[off + _FRAME.size:end]
            off = end
            if zlib.crc32(blob) != crc:
                result["dropped"] += 1
                continue
            try:
                key, out_t, hit_count = pickle.loads(blob)
                out = EpochOutcome(*out_t)
            except Exception:
                result["dropped"] += 1
                continue
            if (not out.seq_digest
                    or seq_digest_of(out.seq) != out.seq_digest):
                result["dropped"] += 1
                continue
            if key in self._entries:
                continue
            self._entries[key] = out
            self._hits_by_key[key] = int(hit_count)
            self.bytes += out.nbytes + len(key)
            result["loaded"] += 1
        result["torn_bytes"] = len(data) - off
        self._evict_to_budget()
        self.loads += 1
        self.load_dropped += result["dropped"]
        return result

    # -- telemetry -----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "hit_rate": self.hit_rate,
            "stores": self.stores, "evictions": self.evictions,
            "corruption_evictions": self.corruption_evictions,
            "spills": self.spills, "loads": self.loads,
            "load_dropped": self.load_dropped,
            "entries": len(self._entries),
            "bytes": self.bytes, "max_bytes": self.max_bytes,
        }


def get_cache(spec) -> Optional[EpochCache]:
    """Normalize an ``epoch_cache`` config knob to an EpochCache or None.

    ``None``/``False`` -> disabled; ``True`` -> a fresh default-budget
    cache; an ``int`` -> a fresh cache with that byte budget; an
    :class:`EpochCache` instance passes through (shared caches: many
    allocators, one profile table)."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return EpochCache()
    if isinstance(spec, int):
        return EpochCache(max_bytes=spec)
    if isinstance(spec, EpochCache):
        return spec
    raise ValueError(f"epoch_cache must be None/bool/int/EpochCache, "
                     f"got {spec!r}")
