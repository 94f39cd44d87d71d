"""Write-ahead epoch journal + crash-consistent recovery for the allocator.

The paper's Mesos prototype survives master failover because Mesos keeps a
replicated registry of the cluster ledger; our reproduction kept the grant
ledger, quarantine decisions and the precomputed-epoch cache in process
memory only.  This module is the durability half of docs/robustness.md:

  * :class:`Journal` — a CRC-framed, length-prefixed append-only log of
    allocator lifecycle records: agent/framework membership changes,
    releases/revocations/forced placements, and the epoch protocol itself
    (epoch-begin with the PR-7 frozen-view fingerprint and the pre-epoch rng
    state, every grant, commit with the grant-sequence digest and post-epoch
    rng state, abort).  Appends flush to the OS per record (a SIGKILL loses
    at most the user-space buffer of the record being written) and fsync in
    groups of ``fsync_every`` records — EXCEPT grant records inside an open
    epoch bracket, whose flush/fsync rides on the bracket-closing
    commit/abort record: recovery discards a bracket with no closing record
    anyway (the deterministic abort), so flushing its grants one by one
    would pay per-grant syscalls for bytes that cannot outlive a crash.
    Opening a journal truncates any torn tail (a partial or CRC-failed
    final record) back to the last whole record.
  * snapshot records — :func:`write_snapshot` persists a full
    :meth:`~repro.core.online.OnlineAllocator.checkpoint` (raw ClusterState
    arrays, framework ledgers, rng state, fault counters) to a separate
    atomically-replaced file carrying the journal position it covers, so
    replay length is bounded by the snapshot cadence, not the journal age.
  * :func:`recover` — the recovery ladder: load the latest snapshot (if
    any), replay the journal records past its position, and deterministically
    abort an epoch that was begun but never committed (grants dropped, rng
    rewound to the epoch's pre-draw position — the PR-8 ``abort_epoch``
    rules).  The recovered allocator's ledger, rng stream and future grant
    sequences are bit-for-bit those of the uninterrupted run (property-swept
    in tests/test_journal.py); the PR-8 invariant auditor is the caller's
    proof obligation on every recovered state.

Bit-exactness is why snapshots serialize the RAW ledger arrays instead of
re-deriving them: re-applying grants on restore would re-run float
accumulation in a different grouping.  Replayed grant records do go through
the live :meth:`~repro.core.online.OnlineAllocator._grant` — in the original
order, from the identical starting arrays, so every intermediate float is
the one the crashed process computed.  Epoch-commit records carry the
POST-epoch rng state: replay never re-draws, it fast-forwards the stream to
exactly where the committed epoch left it (host RRR's lazy per-round draws
included).

Journaling starts from an empty allocator (the serving front-end attaches
the journal before adding agents) or from a state covered by a snapshot;
oblivious-mode replay additionally needs ``framework_demand_oracle`` set,
exactly like the live paths it re-runs.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import struct
import zlib
from typing import Optional

import numpy as np

#: journal / snapshot file headers ("1" is the format version: a mismatch
#: means records were written by an incompatible build and must not replay)
MAGIC = b"RPROJNL1"
SNAP_MAGIC = b"RPROSNP1"

#: canonical file names inside a ``--state-dir``
JOURNAL_FILE = "journal.wal"
SNAPSHOT_FILE = "snapshot.bin"
CACHE_FILE = "epoch_cache.spill"

#: frame header: payload length + crc32(payload)
FRAME = struct.Struct("<II")

# -- record types (the "t" field of every journal record) --------------------
AGENT_ADD = "agent-add"
AGENT_REMOVE = "agent-remove"
FW_REGISTER = "fw-register"
FW_DEREGISTER = "fw-deregister"
SET_WANTED = "set-wanted"
RELEASE = "release"
REVOKE = "revoke"
FORCE_PLACE = "force-place"
GRANT = "grant"
EPOCH_BEGIN = "epoch-begin"
EPOCH_COMMIT = "epoch-commit"
EPOCH_ABORT = "epoch-abort"
FAULT_STATE = "fault-state"
# multi-tenant control plane (repro.core.tenancy): admission-queue and
# credit-ledger mutations.  All three are written OUTSIDE epoch brackets
# (the admission gate runs before _journal_begin), so replay applies them
# eagerly exactly where the live run did; credit records carry ABSOLUTE
# post-op balances, making their replay order-independent.  ADMIT is
# atomic — it subsumes the framework registration (no separate
# fw-register record is written for an admitted framework), so a torn
# tail can never leave a dequeued-but-unregistered framework behind.
ADMIT_ENQUEUE = "admit-enqueue"
ADMIT = "admit"
CREDIT = "credit"


class JournalError(RuntimeError):
    """The journal file is structurally unusable (bad magic, nested epoch
    brackets, a commit digest that contradicts its grant records)."""


def grant_digest(pairs) -> bytes:
    """Order-sensitive digest of a (fid, agent) grant sequence — stored in
    every epoch-commit record and re-derived from the replayed grant records
    at recovery, so a journal whose grants diverge from its own commit
    digest is rejected instead of silently replayed."""
    buf = "".join(f"{fid}\x00{agent}\x01" for fid, agent in pairs)
    return hashlib.blake2b(buf.encode(), digest_size=16).digest()


def scan_journal(path: str):
    """Read every whole, CRC-valid record of a journal file.

    Returns ``(payloads, offsets, good_end, torn_bytes)``: the raw pickled
    payloads, the file offset each frame starts at, the offset past the last
    valid frame, and how many trailing bytes form a torn tail (partial frame
    or CRC mismatch — scanning stops there, matching the open-time
    truncation).  Raises :class:`JournalError` on a foreign header."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(MAGIC):
        return [], [], 0, len(data)
    if not data.startswith(MAGIC):
        raise JournalError(f"{path}: not a journal (bad magic)")
    payloads: list = []
    offsets: list = []
    off = len(MAGIC)
    while off + FRAME.size <= len(data):
        ln, crc = FRAME.unpack_from(data, off)
        end = off + FRAME.size + ln
        if end > len(data):
            break                         # partial final frame: torn tail
        payload = data[off + FRAME.size:end]
        if zlib.crc32(payload) != crc:
            break                         # corrupt tail: stop, truncate here
        payloads.append(payload)
        offsets.append(off)
        off = end
    return payloads, offsets, off, len(data) - off


class Journal:
    """Append-only CRC-framed record log (see the module docstring).

    Opening an existing file truncates its torn tail; ``lsn`` counts the
    records on disk (the replay cursor snapshots reference).  ``append``
    pickles + frames + flushes per record; ``fsync`` batches in groups of
    ``fsync_every`` appends (call :meth:`sync` for an explicit barrier)."""

    def __init__(self, path: str, fsync_every: int = 8):
        self.path = str(path)
        self.fsync_every = max(1, int(fsync_every))
        self.torn_truncated_bytes = 0
        if os.path.exists(self.path) and os.path.getsize(self.path) >= len(MAGIC):
            payloads, _offsets, good_end, torn = scan_journal(self.path)
            self.lsn = len(payloads)
            self._f = open(self.path, "r+b")
            if torn:
                self._f.truncate(good_end)
                self.torn_truncated_bytes = torn
            self._f.seek(good_end)
        else:
            self.lsn = 0
            self._f = open(self.path, "wb")
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        self.records_since_fsync = 0
        self.records_since_snapshot = 0
        self.fsyncs = 0
        self.snapshots = 0
        self._open_epoch = False

    def append(self, rec: dict) -> int:
        """Durably append one record; returns its lsn (0-based)."""
        t = rec.get("t")
        if t == EPOCH_BEGIN:
            self._open_epoch = True
        elif t in (EPOCH_COMMIT, EPOCH_ABORT):
            self._open_epoch = False
        payload = pickle.dumps(rec, protocol=4)
        self._f.write(FRAME.pack(len(payload), zlib.crc32(payload)) + payload)
        lsn = self.lsn
        self.lsn += 1
        self.records_since_fsync += 1
        self.records_since_snapshot += 1
        # grants inside an open bracket defer their flush to the closing
        # commit/abort: recovery drops an unclosed bracket whole, so these
        # bytes cannot outlive a crash no matter how eagerly they hit disk.
        if not (self._open_epoch and t == GRANT):
            self._f.flush()               # past the user-space buffer: a
                                          # SIGKILL now cannot tear this run
                                          # of records, only a power loss can
            if self.records_since_fsync >= self.fsync_every:
                self.sync()
        return lsn

    def sync(self) -> None:
        """fsync barrier: everything appended so far survives power loss."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        self.records_since_fsync = 0

    def mark_snapshot(self) -> None:
        """A snapshot covering the current lsn was persisted (resets the
        ``records_since_snapshot`` replay-lag counter)."""
        self.snapshots += 1
        self.records_since_snapshot = 0

    def counters(self) -> dict:
        """Reset-free durability counters (the serve health endpoint's
        journal-lag view reads these)."""
        return {
            "lsn": self.lsn,
            "records_since_fsync": self.records_since_fsync,
            "records_since_snapshot": self.records_since_snapshot,
            "fsyncs": self.fsyncs,
            "snapshots": self.snapshots,
            "torn_truncated_bytes": self.torn_truncated_bytes,
        }

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def save_snapshot(path: str, payload: dict) -> None:
    """Atomically persist a snapshot payload (CRC-framed, temp + rename —
    a crash mid-write leaves the previous snapshot intact)."""
    blob = pickle.dumps(payload, protocol=4)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(SNAP_MAGIC)
        f.write(FRAME.pack(len(blob), zlib.crc32(blob)))
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> Optional[dict]:
    """Load a snapshot, or None when missing/corrupt (bad magic, short
    file, CRC mismatch) — recovery then falls back to pure journal replay."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    hdr = len(SNAP_MAGIC) + FRAME.size
    if len(data) < hdr or not data.startswith(SNAP_MAGIC):
        return None
    ln, crc = FRAME.unpack_from(data, len(SNAP_MAGIC))
    blob = data[hdr:hdr + ln]
    if len(blob) != ln or zlib.crc32(blob) != crc:
        return None
    try:
        return pickle.loads(blob)
    except Exception:
        return None


def write_snapshot(state_dir: str, al, journal: Optional[Journal] = None) -> int:
    """Persist ``al.checkpoint()`` covering the journal's current position.

    The journal is fsynced FIRST so the recorded ``journal_lsn`` never
    exceeds what is durably on disk; returns that lsn."""
    lsn = 0
    if journal is not None:
        journal.sync()
        lsn = journal.lsn
    save_snapshot(os.path.join(state_dir, SNAPSHOT_FILE),
                  {"alloc": al.checkpoint(), "journal_lsn": lsn})
    if journal is not None:
        journal.mark_snapshot()
    return lsn


# ---------------------------------------------------------------------------
# recovery: snapshot + replay
# ---------------------------------------------------------------------------

def _apply_record(al, rec: dict) -> None:
    """Re-execute one non-epoch journal record against the allocator."""
    t = rec["t"]
    if t == AGENT_ADD:
        al.add_agent(rec["name"], np.asarray(rec["cap"], np.float64))
    elif t == AGENT_REMOVE:
        al.remove_agent(rec["name"])
    elif t == FW_REGISTER:
        al.register(rec["fid"], demand=rec["demand"],
                    wanted_tasks=rec["wanted"], phi=rec["phi"],
                    allowed_agents=rec["allowed"])
    elif t == FW_DEREGISTER:
        al.deregister(rec["fid"])
    elif t == SET_WANTED:
        al.set_wanted(rec["fid"], rec["wanted"])
    elif t == RELEASE:
        al.release_executor(rec["fid"], rec["agent"])
    elif t == REVOKE:
        al.revoke_executor(rec["fid"], rec["agent"])
    elif t == FORCE_PLACE:
        al.force_place(rec["fid"], rec["agent"], rec["n"])
    elif t == FAULT_STATE:
        al.fault_stats.restore(rec["fault"])
        al.device_health.restore(rec["health"])
    elif t in (ADMIT_ENQUEUE, ADMIT, CREDIT):
        cp = al.tenancy
        if cp is None:
            raise JournalError(
                "journal carries tenancy control-plane records but the "
                "recovering allocator has no tenancy attached")
        if t == ADMIT_ENQUEUE:
            cp.enqueue(fid=rec["fid"], tenant=rec["tenant"],
                       demand=rec["demand"], wanted=rec["wanted"],
                       phi=rec["phi"], allowed=rec["allowed"],
                       t_enqueue=rec["tq"], seq=rec["seq"])
        elif t == ADMIT:
            # atomic batch: dequeue + register every framework the gate
            # admitted that epoch from the queued entries (rebuilt by the
            # admit-enqueue replay) — a cut can never separate an
            # admission from its registration (the gate suppresses the
            # separate fw-register records), and the gate-epoch watermark
            # stops the re-run of a dangling epoch from admitting again.
            for fid in rec["fids"]:
                entry = cp.dequeue(fid)
                al.register(entry.fid, demand=entry.demand,
                            wanted_tasks=entry.wanted, phi=entry.phi,
                            allowed_agents=entry.allowed)
                cp.tenant_of[entry.fid] = entry.tenant
            cp.last_gate_epoch = max(cp.last_gate_epoch,
                                     int(rec["epoch"]))
        else:  # CREDIT: absolute post-op maps, plus the jump flag
            cp.restore_credit_state(rec)
            if rec["op"] == "spend-jump":
                cp.find_queued(rec["fid"]).jumped = True
                cp.jumps_total += 1
            elif rec["op"] == "spend-shield":
                cp.shields_total += 1
    else:
        raise JournalError(f"unknown journal record type {t!r}")


def recover(al, state_dir: str) -> dict:
    """The recovery ladder: latest snapshot, then journal replay, then the
    deterministic abort of a dangling (begun, never committed) epoch.

    ``al`` must be a FRESH allocator constructed with the same
    (n_resources, criterion, server_policy, mode) configuration — a
    snapshot restore cross-checks those and refuses a mismatch.  The
    journal, if attached, is detached for the duration of the replay so
    re-executed operations are not re-journaled.  Returns recovery stats
    (what loaded, what replayed, what was skipped or aborted)."""
    stats = {
        "snapshot_loaded": False, "snapshot_corrupt": False,
        "snapshot_lsn": 0, "journal_records": 0, "replayed_records": 0,
        "skipped_older_than_snapshot": 0, "recovered_aborts": 0,
        "dropped_uncommitted_grants": 0, "torn_bytes": 0,
    }
    spath = os.path.join(state_dir, SNAPSHOT_FILE)
    snap_lsn = 0
    if os.path.exists(spath):
        snap = load_snapshot(spath)
        if snap is None:
            stats["snapshot_corrupt"] = True
        else:
            al.restore(snap["alloc"])
            snap_lsn = int(snap["journal_lsn"])
            stats["snapshot_loaded"] = True
            stats["snapshot_lsn"] = snap_lsn

    jpath = os.path.join(state_dir, JOURNAL_FILE)
    payloads: list = []
    if os.path.exists(jpath):
        payloads, _offsets, _good_end, torn = scan_journal(jpath)
        stats["journal_records"] = len(payloads)
        stats["torn_bytes"] = torn
    if snap_lsn > len(payloads):
        # The snapshot covers MORE than the journal holds (the journal was
        # damaged or replaced): the snapshot is self-contained, so trust it
        # and skip the stale records rather than double-applying them.
        stats["skipped_older_than_snapshot"] = len(payloads)
        payloads = []
    else:
        payloads = payloads[snap_lsn:]

    prev_journal, al.journal = al.journal, None
    try:
        pending = None          # open epoch bracket: its begin record
        pending_grants: list = []   # buffered (fid, agent) grant records
        for raw in payloads:
            rec = pickle.loads(raw)
            t = rec["t"]
            if t == EPOCH_BEGIN:
                if pending is not None:
                    raise JournalError("nested epoch-begin records")
                pending, pending_grants = rec, []
            elif t == GRANT:
                if pending is None:     # defensive: bracket-less grant
                    al._grant(rec["fid"], rec["agent"])
                else:
                    pending_grants.append((rec["fid"], rec["agent"]))
            elif t == EPOCH_COMMIT:
                if grant_digest(pending_grants) != rec["seq_digest"]:
                    raise JournalError(
                        "epoch-commit digest does not match its grant "
                        "records (journal corrupt past CRC framing)")
                # restore the counter the live epoch ticked to BEFORE the
                # grants replay: they stamp the hysteresis ledger with it.
                # Only closed brackets restore it — a dangling begin must
                # leave the counter pre-epoch (the deterministic abort
                # recovers "as if the epoch never began", and the re-run
                # re-ticks it).  Pre-tenancy journals carry no "epoch"
                # field; the counter then stays wherever the snapshot
                # left it.
                if pending is not None and "epoch" in pending:
                    al.epoch_counter = int(pending["epoch"])
                for fid, agent in pending_grants:
                    al._grant(fid, agent)
                al.rng.bit_generator.state = rec["rng_state"]
                al.fault_stats.restore(rec["fault"])
                al.device_health.restore(rec["health"])
                pending, pending_grants = None, []
            elif t == EPOCH_ABORT:
                # aborted epochs applied nothing; the record carries the
                # post-abort (rewound) rng position and final counters.
                # The live abort kept the epoch tick (only the DANGLING
                # bracket recovers as never-begun), so restore it here.
                if pending is not None and "epoch" in pending:
                    al.epoch_counter = int(pending["epoch"])
                al.rng.bit_generator.state = rec["rng_state"]
                al.fault_stats.restore(rec["fault"])
                al.device_health.restore(rec["health"])
                pending, pending_grants = None, []
            else:
                _apply_record(al, rec)
            stats["replayed_records"] += 1
        if pending is not None:
            # begun but never committed: the deterministic recovery abort —
            # drop its buffered grants and rewind the rng to the epoch's
            # pre-draw position (the PR-8 abort_epoch rules), so the next
            # epoch draws exactly the stream the dangling one consumed.
            al.rng.bit_generator.state = pending["rng_state0"]
            al.fault_stats.epoch_aborts += 1
            stats["recovered_aborts"] += 1
            stats["dropped_uncommitted_grants"] += len(pending_grants)
    finally:
        al.journal = prev_journal
    al._fair_cache = None
    return stats
